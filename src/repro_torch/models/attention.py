"""Grouped-query attention with RoPE, optional QKV bias, qk-norm and sliding
window; full-sequence (train/prefill) and single-step (decode) paths (the
port of ``repro.models.attention``).

Plain tensor code, as in the reference: the logits are float32, masked
entries are filled with -1e30 before the softmax, and ``flash_sdpa``
multiplies P by V with both rounded to bf16 and the products summed in
float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init

MASK_FILL = -1e30


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0          # 0 => full causal attention


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32):
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_heads * cfg.head_dim,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_heads * cfg.head_dim,
                         bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model,
                         dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, dtype, gen.device)
    return p


def _project_qkv(p, cfg: AttnConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = dense(p["wk"], x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
    v = dense(p["wv"], x).reshape(B, S, cfg.kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """q [B,Sq,H,D]; k,v [B,Sk,Hkv,D]; mask [B or 1, 1, Sq, Sk] bool ->
    f32 [B, Sq, H*D]."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    qg = q.reshape(B, Sq, Hkv, groups, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (D ** -0.5)
    logits = logits.masked_fill(~mask[:, :, None], MASK_FILL)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    return out.reshape(B, Sq, H * D)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: AttnConfig, *, q_offset: int = 0, q_chunk: int = 1024,
               k_chunk: int = 1024) -> torch.Tensor:
    """Blockwise (FlashAttention-style) causal SDPA: online softmax over
    key chunks, looped over query chunks. Memory is O(q_chunk * k_chunk)
    instead of O(Sq * Sk). Fully-masked key blocks are still computed (and
    masked), as in the reference. -> f32 [B, Sq, H*D]."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qc = min(q_chunk, Sq)
    kc = min(k_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    Sq_p, Sk_p = nq * qc, nk * kc
    scale = D ** -0.5
    dev = q.device

    def pad_seq(t, n):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n - t.shape[1]))

    # [nq, B, Hkv, g, qc, D] / [nk, B, Hkv, kc, D]
    qf = pad_seq(q, Sq_p).reshape(B, nq, qc, Hkv, g, D).permute(
        1, 0, 3, 4, 2, 5)
    kf = pad_seq(k, Sk_p).reshape(B, nk, kc, Hkv, D).permute(1, 0, 3, 2, 4)
    vf = pad_seq(v, Sk_p).reshape(B, nk, kc, Hkv, D).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(nq):
        qb = qf[qi].to(torch.float32)               # [B, Hkv, g, qc, D]
        qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, Hkv, g, qc), float("-inf"), device=dev)
        l = torch.zeros((B, Hkv, g, qc), device=dev)
        acc = torch.zeros((B, Hkv, g, qc, D), device=dev)
        for ki in range(nk):
            kpos = ki * kc + torch.arange(kc, device=dev)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qb,
                                  kf[ki].to(torch.float32)) * scale
            mask = kpos[None, :] <= qpos[:, None]
            if cfg.sliding_window > 0:
                mask &= kpos[None, :] > qpos[:, None] - cfg.sliding_window
            logits = logits.masked_fill(~mask, MASK_FILL)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            # PV in bf16 with float32 sums (the reference's
            # preferred_element_type=f32 product): both operands rounded
            # to bf16, their exact products summed in float32
            pv = torch.einsum(
                "bhgqk,bhkd->bhgqd",
                p.to(torch.bfloat16).to(torch.float32),
                vf[ki].to(torch.bfloat16).to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    # [nq, B, Hkv, g, qc, D] -> [B, Sq, H*D]
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        B, Sq_p, H * D)
    return out[:, :Sq]


FLASH_THRESHOLD = 2048


def causal_mask(Sq: int, Sk: int, offset: int = 0, sliding_window: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, Sq, Sk] bool; query i attends to keys <= i+offset, and within
    the window if sliding_window > 0."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if sliding_window > 0:
        m &= ki > qi - sliding_window
    return m[None, None]


def _full_sdpa(q, k, v, cfg: AttnConfig) -> torch.Tensor:
    S = q.shape[1]
    if S >= FLASH_THRESHOLD:
        return flash_sdpa(q, k, v, cfg)
    mask = causal_mask(S, S, 0, cfg.sliding_window, q.device)
    return _sdpa(q, k, v, mask, cfg)


def attention(p, cfg: AttnConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              vmap_q: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill). ``vmap_q`` is the
    reference's switch of its query-chunk loop from scan to vmap under
    sequence parallelism: it changes no value, and the port's loop is
    the same either way."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _full_sdpa(q, k, v, cfg)
    return dense(p["wo"], out.to(x.dtype))


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, S_max, Hkv, D]
    v: torch.Tensor        # [B, S_max, Hkv, D]

    @classmethod
    def init(cls, B: int, S_max: int, cfg: AttnConfig,
             dtype=torch.bfloat16, device=None):
        shape = (B, S_max, cfg.kv_heads, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(p, cfg: AttnConfig, x: torch.Tensor, cache: KVCache,
                     pos: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """One new token per sequence. x: [B, 1, d_model]; pos: [B] int index
    of the new token. Attends to cache[0:pos] + itself.

    The new key and value are written into ``cache`` in place, row b at
    ``pos[b]`` (the reference returns an updated copy); the returned
    cache holds the same tensors."""
    B, S1, _ = x.shape
    assert S1 == 1
    S_max = cache.k.shape[1]
    q, k, v = _project_qkv(p, cfg, x, pos[:, None])
    rows = torch.arange(B, device=x.device)
    pos_l = pos.long()
    cache.k[rows, pos_l] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, pos_l] = v[:, 0].to(cache.v.dtype)
    ki = torch.arange(S_max, device=x.device)[None, :]      # [1, S_max]
    m = ki <= pos_l[:, None]
    if cfg.sliding_window > 0:
        m &= ki > (pos_l[:, None] - cfg.sliding_window)
    mask = m[:, None, None, :]                              # [B, 1, 1, S_max]
    out = _sdpa(q, cache.k, cache.v, mask, cfg)
    return dense(p["wo"], out.to(x.dtype)), cache


def prefill_cache(p, cfg: AttnConfig, x: torch.Tensor, S_max: int,
                  dtype=torch.bfloat16, vmap_q: bool = False
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Run full attention over the prompt and return output + primed
    cache (``vmap_q`` as in :func:`attention`)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _full_sdpa(q, k, v, cfg)
    cache = KVCache.init(B, S_max, cfg, dtype, x.device)
    cache.k[:, :S] = k.to(dtype)
    cache.v[:, :S] = v.to(dtype)
    return dense(p["wo"], out.to(x.dtype)), cache
