"""Composable decoder LM (the port of ``repro.models.model``): the forward
pass and the serving path (prefill + greedy decode with KV caches).

A model is a cycled *group* of layer slots (``ModelConfig.group_slots``).
The reference stacks each slot's parameters over the groups and runs the
stack under ``lax.scan``; here the parameters are a module tree with one
module per layer (``params["layers"][l]``; layer ``l`` is slot
``l % group_size`` of group ``l // group_size``) and the stack is a Python
loop. The KV caches keep the reference's structure: one ``KVCache`` per
slot, stacked over the groups (``[n_groups, B, S_max, Hkv, D]``).

This slice carries ``"attn"`` mixers with ``"dense"``, ``"moe"`` or
``"none"`` MLPs, rms/ln norms, rope/sinusoidal positions and the vision
frontend stub. The SSM mixer, the training loss and the expert-parallel
MoE dispatch come with later slices and raise here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import (AttnConfig, KVCache, attention, attention_decode,
                        attn_init, prefill_cache)
from .layers import (dense, dense_init, layernorm, layernorm_init, normal,
                     rmsnorm, rmsnorm_init)
from .moe import MoEConfig, moe_apply, moe_init
from .ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0
    norm: str = "rms"                      # "rms" | "ln"
    mlp_act: str = "swiglu"                # "swiglu" | "gelu" | "none"
    pos: str = "rope"                      # "rope" | "sinusoidal"
    tie_embeddings: bool = False
    block_pattern: Tuple[str, ...] = ("attn",)     # cycled mixer kinds
    mlp_pattern: Tuple[str, ...] = ("dense",)      # "dense"|"moe"|"none"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_use_kernel: bool = False
    moe_plain: bool = False     # with moe_use_kernel: K9's plain version
    # SSM (mamba2)
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    # frontend stub
    frontend: str = "none"                 # "none" | "audio" | "vision"
    vision_tokens: int = 0
    vision_dim: int = 1024
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    loss_chunk: int = 512
    # expert-parallel MoE dispatch ("" | "ep" | "ep_tp"): the LM mesh slice
    moe_ep: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        return _lcm(len(self.block_pattern), len(self.mlp_pattern))

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.group_size == 0, \
            (self.n_layers, self.group_size)
        return self.n_layers // self.group_size

    def attn_config(self) -> AttnConfig:
        return AttnConfig(self.d_model, self.n_heads, self.kv_heads,
                          self.hd, self.rope_theta, self.qkv_bias,
                          self.qk_norm, self.sliding_window)

    def ssm_config(self) -> SSMConfig:
        return SSMConfig(self.d_model, self.ssm_state, 4, 2,
                         self.ssm_headdim, self.ssm_chunk)

    def moe_config(self) -> MoEConfig:
        return MoEConfig(self.d_model, self.d_ff, self.n_experts,
                         self.top_k, self.moe_use_kernel,
                         plain=self.moe_plain)

    def group_slots(self):
        """[(mixer_kind, mlp_kind)] for one group."""
        g = self.group_size
        return [(self.block_pattern[i % len(self.block_pattern)],
                 self.mlp_pattern[i % len(self.mlp_pattern)])
                for i in range(g)]

    def param_count(self, params=None) -> int:
        if params is None:
            return -1
        return sum(p.numel() for p in params.parameters())


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def _ssm_missing() -> NotImplementedError:
    return NotImplementedError(
        "the SSM mixer (models/ssm.py) is not ported yet: ROADMAP.md queue "
        "1 item 3")


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree, indexed by name like the
    reference's parameter pytree (``p["mixer"]["wq"]["w"]``, ``"b" in
    p``); a list becomes an ``nn.ModuleList`` of trees (the layers). The
    model's tree holds ``embed``, ``final_norm``, ``layers`` (one tree per
    layer) and ``unembed``/``vision_proj`` where the config has them."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.add_module(name, ParamTree(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _norm_init(cfg, d, device):
    return rmsnorm_init(d, cfg.param_dtype, device) if cfg.norm == "rms" \
        else layernorm_init(d, cfg.param_dtype, device)


def _norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rms" else layernorm(p, x)


def _mlp_init(gen, cfg: ModelConfig):
    if cfg.mlp_act == "swiglu":
        return {"w_gate": dense_init(gen, cfg.d_model, cfg.d_ff,
                                     dtype=cfg.param_dtype),
                "w_up": dense_init(gen, cfg.d_model, cfg.d_ff,
                                   dtype=cfg.param_dtype),
                "w_down": dense_init(gen, cfg.d_ff, cfg.d_model,
                                     dtype=cfg.param_dtype)}
    return {"w_in": dense_init(gen, cfg.d_model, cfg.d_ff, bias=True,
                               dtype=cfg.param_dtype),
            "w_out": dense_init(gen, cfg.d_ff, cfg.d_model, bias=True,
                                dtype=cfg.param_dtype)}


def _mlp_apply(cfg: ModelConfig, p, x):
    if cfg.mlp_act == "swiglu":
        h = F.silu(dense(p["w_gate"], x).to(torch.float32)) \
            * dense(p["w_up"], x).to(torch.float32)
        return dense(p["w_down"], h.to(x.dtype))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dense(p["w_in"], x).to(torch.float32), approximate="tanh")
    return dense(p["w_out"], h.to(x.dtype))


def _slot_init(gen, cfg: ModelConfig, mixer: str, mlp: str):
    p: Dict[str, Any] = {"norm1": _norm_init(cfg, cfg.d_model, gen.device)}
    if mixer == "attn":
        p["mixer"] = attn_init(gen, cfg.attn_config(), cfg.param_dtype)
    elif mixer == "ssm":
        raise _ssm_missing()
    else:
        raise ValueError(mixer)
    if mlp != "none":
        p["norm2"] = _norm_init(cfg, cfg.d_model, gen.device)
        if mlp == "moe":
            p["mlp"] = moe_init(gen, cfg.moe_config(), cfg.param_dtype)
        else:
            p["mlp"] = _mlp_init(gen, cfg)
    return p


def layer_kinds(cfg: ModelConfig, layer: int) -> Tuple[str, str]:
    """(mixer, mlp) kinds of layer ``layer``."""
    return cfg.group_slots()[layer % cfg.group_size]


def init_params(gen: torch.Generator, cfg: ModelConfig) -> ParamTree:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    params: Dict[str, Any] = {
        "embed": normal(gen, (cfg.vocab, cfg.d_model), cfg.param_dtype,
                        cfg.d_model ** -0.5),
        "final_norm": _norm_init(cfg, cfg.d_model, gen.device),
        "layers": [_slot_init(gen, cfg, *layer_kinds(cfg, l))
                   for l in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab,
                                       dtype=cfg.param_dtype)
    if cfg.frontend == "vision":
        params["vision_proj"] = dense_init(gen, cfg.vision_dim, cfg.d_model,
                                           dtype=cfg.param_dtype)
    return ParamTree(params)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def _sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """[..., d] sinusoidal embedding of float positions ``pos``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None] / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _moe(cfg: ModelConfig, p, hn):
    if cfg.moe_ep:
        raise NotImplementedError(
            f"expert-parallel MoE dispatch (moe_ep={cfg.moe_ep!r}) comes "
            "with the LM mesh slice")
    return moe_apply(p, cfg.moe_config(), hn)


def _mlp_block(cfg: ModelConfig, lp, mlp: str, h):
    """h + MLP(norm2(h)) -> (h, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mlp == "none":
        return h, aux
    hn = _norm(cfg, lp["norm2"], h)
    if mlp == "moe":
        out, aux = _moe(cfg, lp["mlp"], hn)
    else:
        out = _mlp_apply(cfg, lp["mlp"], hn)
    return h + out, aux


def embed_inputs(cfg: ModelConfig, params, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    h = params["embed"][tokens].to(cfg.compute_dtype)
    if cfg.pos == "sinusoidal":
        pos = torch.arange(h.shape[1], dtype=torch.float32, device=h.device)
        h = h + _sinusoidal_at(pos, cfg.d_model)[None].to(h.dtype)
    if cfg.frontend == "vision":
        assert vision_embeds is not None, "vision frontend needs embeds"
        v = dense(params["vision_proj"],
                  vision_embeds.to(cfg.compute_dtype))
        h = torch.cat([v, h], dim=1)
    return h


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final-normed hidden [B, S', d], aux_loss)."""
    h = embed_inputs(cfg, params, tokens, vision_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for l, lp in enumerate(params["layers"]):
        mixer, mlp = layer_kinds(cfg, l)
        if mixer != "attn":
            raise _ssm_missing()
        h = h + attention(lp["mixer"], cfg.attn_config(),
                          _norm(cfg, lp["norm1"], h))
        h, a = _mlp_block(cfg, lp, mlp, h)
        aux = aux + a
    h = _norm(cfg, params["final_norm"], h)
    return h, aux


def logits_from_hidden(params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h.to(torch.float32) @ params["embed"].to(torch.float32).T
    return dense(params["unembed"], h, compute_dtype=cfg.compute_dtype
                 ).to(torch.float32)


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-slot caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
               device=None) -> List[KVCache]:
    """One cache per slot, stacked over the groups:
    ``[n_groups, B, S_max, Hkv, D]``."""
    caches = []
    for mixer, _mlp in cfg.group_slots():
        if mixer != "attn":
            raise _ssm_missing()
        shape = (cfg.n_groups, B, S_max, cfg.kv_heads, cfg.hd)
        caches.append(KVCache(torch.zeros(shape, dtype=dtype, device=device),
                              torch.zeros(shape, dtype=dtype, device=device)))
    return caches


def _layer_cache(caches: List[KVCache], cfg: ModelConfig,
                 layer: int) -> KVCache:
    """Views of layer ``layer``'s rows of the stacked caches."""
    g, slot = divmod(layer, cfg.group_size)
    return KVCache(caches[slot].k[g], caches[slot].v[g])


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                caches: List[KVCache], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, List[KVCache]]:
    """token [B, 1] int; pos [B] int -> (logits f32 [B, vocab], caches).
    The caches are updated in place and returned."""
    h = params["embed"][token].to(cfg.compute_dtype)
    if cfg.pos == "sinusoidal":
        h = h + _sinusoidal_at(pos.to(torch.float32), cfg.d_model
                               )[:, None].to(h.dtype)
    for l, lp in enumerate(params["layers"]):
        mixer, mlp = layer_kinds(cfg, l)
        if mixer != "attn":
            raise _ssm_missing()
        out, _ = attention_decode(lp["mixer"], cfg.attn_config(),
                                  _norm(cfg, lp["norm1"], h),
                                  _layer_cache(caches, cfg, l), pos)
        h, _ = _mlp_block(cfg, lp, mlp, h + out)
    h = _norm(cfg, params["final_norm"], h)
    return logits_from_hidden(params, cfg, h)[:, 0], caches


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, S_max: int,
            cache_dtype=torch.bfloat16,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[KVCache]]:
    """Run the prompt, returning (last-token logits f32 [B, vocab], primed
    caches)."""
    h = embed_inputs(cfg, params, tokens, vision_embeds)
    caches = init_cache(cfg, h.shape[0], S_max, cache_dtype, h.device)
    for l, lp in enumerate(params["layers"]):
        mixer, mlp = layer_kinds(cfg, l)
        if mixer != "attn":
            raise _ssm_missing()
        out, nc = prefill_cache(lp["mixer"], cfg.attn_config(),
                                _norm(cfg, lp["norm1"], h), S_max,
                                cache_dtype)
        view = _layer_cache(caches, cfg, l)
        view.k.copy_(nc.k)
        view.v.copy_(nc.v)
        h, _ = _mlp_block(cfg, lp, mlp, h + out)
    h = _norm(cfg, params["final_norm"], h)
    logits = logits_from_hidden(params, cfg, h[:, -1:])[:, 0]
    return logits, caches
