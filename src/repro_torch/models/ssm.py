"""Mamba-2 (SSD — state-space duality) layer [arXiv:2405.21060], the port
of ``repro.models.ssm``.

Chunked SSD algorithm: within a chunk the recurrence is computed in its
"attention dual" form (C B^T masked by the decay kernel), across chunks a
[H, P, N] state is carried — O(S L) work, O(S/L) sequential steps. Decode
carries (conv_state, ssm_state) and costs O(1) per token.

The reference scans the chunks with ``lax.scan(jax.checkpoint(...))``;
here the chunks are a Python loop, and with grad enabled each chunk runs
under ``torch.utils.checkpoint`` so its [B, L, L, H] decay kernel is
recomputed in the backward pass, not stored. The module reaches no
Pallas kernel, so plain torch is its port.

One difference from the reference, in the gradient only: the decay
kernel's exponent is masked to -inf above the diagonal before ``exp``.
The reference takes ``exp`` of the unmasked differences and masks the
product after it; a chunk whose decay sum passes ~88 (mamba2-1.3b's
128-step chunks at init) overflows to inf there, and the backward pass
multiplies that inf by a zero cotangent (NaN). The forward values are the
same: the masked entries are 0 on both sides.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import (causal_conv1d, causal_conv1d_init, dense, dense_init,
                     draw_from)


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (no linear
    shortcut above a threshold, as ``F.softplus`` has)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_init(gen: torch.Generator, cfg: SSMConfig, dtype=torch.float32):
    di, N, H = cfg.d_inner, cfg.d_state, cfg.nheads
    d_in_proj = 2 * di + 2 * N + H           # z, x, B, C, dt (ngroups=1)
    conv_ch = di + 2 * N
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((H,), generator=draw_from(gen), device=dev) \
        * (hi - lo) + lo
    return {
        "in_proj": dense_init(gen, cfg.d_model, d_in_proj, dtype=dtype),
        "conv": causal_conv1d_init(gen, conv_ch, cfg.d_conv, dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)
                           .to(dtype)),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, cfg.d_model, dtype=dtype),
    }


def _split_proj(p, cfg: SSMConfig, u: torch.Tensor):
    di, N = cfg.d_inner, cfg.d_state
    zxbcdt = dense(p["in_proj"], u)
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + di + 2 * N]
    dt = zxbcdt[..., di + di + 2 * N:]
    return z, xBC, dt


def _gated_norm(p, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)
            * p["norm_scale"].to(torch.float32)).to(y.dtype)


def _chunk_step(state, xk, Bk, Ck, dtk, lak):
    """One chunk: state [B, H, P, N]; xk [B, L, H, P], Bk/Ck [B, L, N],
    dtk/lak [B, L, H] -> (state, y [B, L, H, P])."""
    L = xk.shape[1]
    cs = torch.cumsum(lak, dim=1)                              # [B, L, H]
    # intra-chunk (attention-dual): score[i,j] = (C_i . B_j)
    #   * exp(cs_i - cs_j) * dt_j for j <= i
    cb = torch.einsum("bin,bjn->bij", Ck, Bk)                  # [B, L, L]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xk.device))[None, ..., None]
    seg = torch.where(causal, cs[:, :, None] - cs[:, None],
                      float("-inf"))
    scr = cb[..., None] * torch.exp(seg) * dtk[:, None]        # [B,L,L,H]
    y_intra = torch.einsum("bijh,bjhp->bihp", scr, xk)
    # inter-chunk: y_i += exp(cs_i) * C_i . state
    y_inter = torch.einsum("bin,bhpn->bihp", Ck, state) \
        * torch.exp(cs)[..., None]
    # state update: S' = exp(cs_L) S + sum_j exp(cs_L - cs_j) dt_j x_j B_j
    tail = torch.exp(cs[:, -1:] - cs) * dtk                    # [B, L, H]
    upd = torch.einsum("bjh,bjhp,bjn->bhpn", tail, xk, Bk)
    state = state * torch.exp(cs[:, -1])[..., None, None] + upd
    return state, y_intra + y_inter


def _conv_act(p, cfg: SSMConfig, u: torch.Tensor):
    """The projections, the conv and the SiLU of ``u`` [B, S, d]: (z, x
    [B, S, H, P], B [B, S, N], C [B, S, N], dt [B, S, H], the conv's new
    state), x/B/C/dt in float32."""
    B, S, _ = u.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.nheads, cfg.headdim
    z, xBC, dt = _split_proj(p, cfg, u)
    xBC, conv_state = causal_conv1d(p["conv"], xBC)
    xBC = F.silu(xBC.to(torch.float32))
    x = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + N]                       # [B, S, N] (ngroups=1)
    Cm = xBC[..., di + N:]
    dt = softplus(dt.to(torch.float32)
                  + p["dt_bias"].to(torch.float32))            # [B, S, H]
    return z, x, Bm, Cm, dt, conv_state


def ssm_forward(p, cfg: SSMConfig, u: torch.Tensor,
                initial_state: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """u: [B, S, d_model] -> [B, S, d_model] (training / prefill)."""
    B, S, _ = u.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.nheads, cfg.headdim
    L = min(cfg.chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    z, x, Bm, Cm, dt, _ = _conv_act(p, cfg, u)
    A = -torch.exp(p["A_log"].to(torch.float32))               # [H]
    loga = dt * A[None, None]                                  # [B, S, H]

    # pad to a chunk multiple (decay 0 contributions for padded steps)
    xp = F.pad(x, (0, 0, 0, 0, 0, pad))
    Bp, Cp = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    dtp, lap = F.pad(dt, (0, 0, 0, pad)), F.pad(loga, (0, 0, 0, pad))

    state = initial_state if initial_state is not None else \
        torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device)
    remat = torch.is_grad_enabled()
    ys = []
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L)
        args = (state, xp[:, sl], Bp[:, sl], Cp[:, sl], dtp[:, sl],
                lap[:, sl])
        # checkpoint: the [B, L, L, H] decay kernel is recomputed in
        # backward
        if remat:
            state, y = checkpoint(_chunk_step, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            state, y = _chunk_step(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]                            # [B,S,H,P]
    y = y + x * p["D"].to(torch.float32)[None, None, :, None]
    y = _gated_norm(p, y.reshape(B, S, di), z)
    return dense(p["out_proj"], y.to(u.dtype))


class SSMCache(NamedTuple):
    conv_state: torch.Tensor     # [B, d_conv-1, conv_ch]
    ssm_state: torch.Tensor      # [B, H, P, N] f32

    @classmethod
    def init(cls, B: int, cfg: SSMConfig, dtype=torch.float32,
             device=None) -> "SSMCache":
        conv_ch = cfg.d_inner + 2 * cfg.d_state
        return cls(torch.zeros((B, cfg.d_conv - 1, conv_ch), dtype=dtype,
                               device=device),
                   torch.zeros((B, cfg.nheads, cfg.headdim, cfg.d_state),
                               dtype=torch.float32, device=device))


def ssm_decode(p, cfg: SSMConfig, u: torch.Tensor, cache: SSMCache
               ) -> Tuple[torch.Tensor, SSMCache]:
    """u: [B, 1, d_model] one token; O(1) state update. Returns new cache
    tensors (``cache`` is not written)."""
    B = u.shape[0]
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.nheads, cfg.headdim
    z, xBC, dt = _split_proj(p, cfg, u)
    xBC, conv_state = causal_conv1d(p["conv"], xBC, cache.conv_state)
    xBC = F.silu(xBC.to(torch.float32))
    x = xBC[:, 0, :di].reshape(B, H, P)
    Bm = xBC[:, 0, di:di + N]
    Cm = xBC[:, 0, di + N:]
    dt = softplus(dt[:, 0].to(torch.float32)
                  + p["dt_bias"].to(torch.float32))            # [B, H]
    a = torch.exp(dt * -torch.exp(p["A_log"].to(torch.float32)))  # [B, H]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, Bm)
    state = cache.ssm_state * a[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, state) \
        + x * p["D"].to(torch.float32)[None, :, None]
    y = _gated_norm(p, y.reshape(B, 1, di), z)
    out = dense(p["out_proj"], y.to(u.dtype))
    return out, SSMCache(conv_state, state)


def ssm_forward_naive(p, cfg: SSMConfig, u: torch.Tensor) -> torch.Tensor:
    """Step-by-step recurrence oracle (tests and the card's check)."""
    B, S, _ = u.shape
    cache = SSMCache.init(B, cfg, u.dtype, u.device)
    outs = []
    for t in range(S):
        o, cache = ssm_decode(p, cfg, u[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
