"""Composable decoder LM (the port of ``repro.models.model``): the forward
pass, the training loss and the serving path (prefill + greedy decode with
per-slot caches).

A model is a cycled *group* of layer slots (``ModelConfig.group_slots``;
jamba = 1 attn + 7 ssm per group, MoE on every other slot). The reference
stacks each slot's parameters over the groups and runs the stack under
``lax.scan``; here the parameters are a module tree with one module per
layer (``params["layers"][l]``; layer ``l`` is slot ``l % group_size`` of
group ``l // group_size``) and the stack is a Python loop over groups,
each group under ``torch.utils.checkpoint`` when ``cfg.remat`` and grad
are on. The caches keep the reference's structure: one ``KVCache`` or
``SSMCache`` per slot, stacked over the groups (``[n_groups, B, S_max,
Hkv, D]``; ``[n_groups, B, d_conv-1, conv_ch]`` and ``[n_groups, B, H, P,
N]``).

Every mixer ("attn", "ssm") and MLP ("dense", "moe", "none") of the
reference is here, with rms/ln norms, rope/sinusoidal positions and the
vision frontend stub. On a mesh (``launch.mesh.set_mesh``) the MoE layers
dispatch expert-parallel when ``moe_ep`` says so (``moe_apply_ep``,
``moe_apply_ep_tp``), and ``_constrain_batch`` checks the batch and
sequence axes as JAX's ``with_sharding_constraint`` would.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import (AttnConfig, KVCache, attention, attention_decode,
                        attn_init, prefill_cache)
from .layers import (dense, dense_init, layernorm, layernorm_init, normal,
                     rmsnorm, rmsnorm_init)
from .moe import (MoEConfig, moe_apply, moe_apply_ep, moe_apply_ep_tp,
                  moe_init)
from .ssm import (SSMCache, SSMConfig, _conv_act, ssm_decode, ssm_forward,
                  ssm_init)


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
    remat: bool = True         # each group under torch.utils.checkpoint
    loss_chunk: int = 512
    # distribution (set by launch.steps / launch.train on a mesh): the
    # mesh axes activations shard their batch dim over
    batch_axes: Tuple[str, ...] = ()
    # expert-parallel MoE dispatch ("" | "ep" | "ep_tp")
    moe_ep: str = ""
    moe_capacity_factor: float = 1.3
    # sequence parallelism: activations shard dim 1 over these axes
    seq_axes: Tuple[str, ...] = ()
    seq_axes_size: int = 1

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


def _constrain_batch(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The reference pins the leading (batch) dim of an activation to the
    DP axes, and with sequence parallelism dim 1 to the seq axes, with
    ``jax.lax.with_sharding_constraint``. That changes no value, and here
    no layout either: the mesh train step and the expert-parallel
    dispatch place the batch themselves. It raises where JAX would: with
    no ambient mesh, on an axis the mesh lacks, or on a batch the axes do
    not divide (inside ``at_coords``, x is already its data block)."""
    if not cfg.batch_axes and not cfg.seq_axes:
        return x
    from repro_torch.launch.mesh import current_mesh, local_coords
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("a sharding constraint on batch_axes "
                           f"{cfg.batch_axes} needs an ambient mesh "
                           "(launch.mesh.set_mesh)")
    size = dict(zip(mesh.axis_names, mesh.devices.shape))
    for a in tuple(cfg.batch_axes) + tuple(cfg.seq_axes):
        if a not in size:
            raise ValueError(f"axis {a!r} is not in the mesh "
                             f"{mesh.axis_names}")
    local = local_coords()
    n = int(np.prod([size[a] for a in cfg.batch_axes if a not in local]))
    if x.shape[0] % n:
        raise ValueError(f"the batch dimension {x.shape[0]} is not "
                         f"divisible by {n} (axes {cfg.batch_axes})")
    return x


class ParamTree(nn.Module):
    """A nested dict of tensors as a module tree, indexed by name like the
    reference's parameter pytree (``p["mixer"]["wq"]["w"]``, ``"b" in
    p``); a list becomes an ``nn.ModuleList`` of trees (the layers). The
    model's tree holds ``embed``, ``final_norm``, ``layers`` (one tree per
    layer) and ``unembed``/``vision_proj`` where the config has them.

    ``group_size`` (the model's tree only) says which layers share a slot:
    ``leaf_stacks`` gives the reference's leaves, each slot leaf as the
    list of its layers' tensors over the groups, which the optimizers
    update as one stacked leaf (Adafactor factors and clips across it as
    the reference does)."""

    def __init__(self, tree: Dict[str, Any], group_size: int = 0):
        super().__init__()
        self.group_size = group_size
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

    def leaf_stacks(self) -> List[Tuple[str, List[torch.Tensor], bool]]:
        """``[(name, tensors, stacked)]`` in parameter order: with a
        ``group_size``, a leaf of layer ``l`` joins the stack of slot ``l %
        group_size`` (named after that slot's first layer), ordered by
        group; every other leaf stands alone."""
        stacks: Dict[str, Tuple[List[torch.Tensor], bool]] = {}
        for name, t in self.named_parameters():
            parts = name.split(".")
            stacked = bool(self.group_size) and parts[0] == "layers"
            if stacked:
                parts[1] = str(int(parts[1]) % self.group_size)
            stacks.setdefault(".".join(parts), ([], stacked))[0].append(t)
        return [(n, ts, st) for n, (ts, st) in stacks.items()]


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
        p["mixer"] = ssm_init(gen, cfg.ssm_config(), cfg.param_dtype)
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
    return ParamTree(params, cfg.group_size)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def _sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """[..., d] sinusoidal embedding of float positions ``pos``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos[..., None] / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _moe(cfg: ModelConfig, p, hn):
    if cfg.moe_ep == "ep":
        return moe_apply_ep(p, cfg.moe_config(), hn,
                            batch_axes=cfg.batch_axes,
                            capacity_factor=cfg.moe_capacity_factor)
    if cfg.moe_ep == "ep_tp":
        return moe_apply_ep_tp(p, cfg.moe_config(), hn,
                               batch_axes=cfg.batch_axes)
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


def _apply_slot(cfg: ModelConfig, lp, mixer: str, mlp: str,
                h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    hn = _norm(cfg, lp["norm1"], h)
    if mixer == "attn":
        h = h + attention(lp["mixer"], cfg.attn_config(), hn)
    else:
        h = h + ssm_forward(lp["mixer"], cfg.ssm_config(), hn)
    return _mlp_block(cfg, lp, mlp, h)


def _run_groups(cfg: ModelConfig, params, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack, group by group; with ``cfg.remat`` and grad on,
    each group runs under ``torch.utils.checkpoint`` (its activations are
    recomputed in the backward pass)."""
    slots = cfg.group_slots()
    gs = cfg.group_size
    layers = params["layers"]

    def group_fn(g, h, aux):
        for i, (mixer, mlp) in enumerate(slots):
            h, a = _apply_slot(cfg, layers[g * gs + i], mixer, mlp, h)
            aux = aux + a
        return _constrain_batch(cfg, h), aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(cfg.n_groups):
        if remat:
            h, aux = checkpoint(group_fn, g, h, aux, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            h, aux = group_fn(g, h, aux)
    return h, aux


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
    return _constrain_batch(cfg, h)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (final-normed hidden [B, S', d], aux_loss)."""
    h = embed_inputs(cfg, params, tokens, vision_embeds)
    h, aux = _run_groups(cfg, params, h)
    h = _norm(cfg, params["final_norm"], h)
    return h, aux


def logits_from_hidden(params, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h.to(torch.float32) @ params["embed"].to(torch.float32).T
    return dense(params["unembed"], h, compute_dtype=cfg.compute_dtype
                 ).to(torch.float32)


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor,
            vision_embeds: Optional[torch.Tensor] = None,
            loss_mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE, computed in sequence chunks of ``cfg.loss_chunk`` so
    [B, S, V] logits are never materialized (vocab up to 152k); with grad
    on, each chunk's logits are recomputed in the backward pass. Adds the
    MoE load-balance loss."""
    h, aux = forward(params, cfg, tokens, vision_embeds)
    if cfg.frontend == "vision":
        h = h[:, -tokens.shape[1]:]        # loss over text positions only
    B, S, _ = h.shape
    targets = tokens[:, 1:].long()         # predict t+1
    h = h[:, :-1]
    mask = torch.ones(targets.shape, dtype=torch.float32, device=h.device) \
        if loss_mask is None else loss_mask[:, 1:].to(torch.float32)

    def chunk_loss(hc, tc, mc):
        lg = logits_from_hidden(params, cfg, hc)
        lse = torch.logsumexp(lg, dim=-1)
        tok_lp = torch.gather(lg, -1, tc[..., None])[..., 0]
        return ((lse - tok_lp) * mc).sum()

    C = min(cfg.loss_chunk, S - 1)
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S - 1, C):
        args = (h[:, c0:c0 + C], targets[:, c0:c0 + C], mask[:, c0:c0 + C])
        # checkpoint: never keep a [B, C, vocab] logits chunk for backward
        total = total + (checkpoint(chunk_loss, *args, use_reentrant=False,
                                    preserve_rng_state=False)
                         if remat else chunk_loss(*args))
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = total / denom + aux
    return loss, {"ce": total / denom, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# serving: prefill + decode with per-slot caches
# ---------------------------------------------------------------------------
Cache = Union[KVCache, SSMCache]


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
               device=None) -> List[Cache]:
    """One cache per slot, stacked over the groups: a ``KVCache``
    ``[n_groups, B, S_max, Hkv, D]`` in ``dtype``, or an ``SSMCache``
    (conv state ``[n_groups, B, d_conv-1, conv_ch]`` in ``dtype``, SSM
    state ``[n_groups, B, H, P, N]`` in float32)."""
    G = cfg.n_groups
    caches: List[Cache] = []
    for mixer, _mlp in cfg.group_slots():
        if mixer == "attn":
            shape = (G, B, S_max, cfg.kv_heads, cfg.hd)
            caches.append(KVCache(
                torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device)))
        else:
            one = SSMCache.init(B, cfg.ssm_config(), dtype, device)
            caches.append(SSMCache(*(t.new_zeros((G,) + t.shape)
                                     for t in one)))
    return caches


def _layer_cache(caches: List[Cache], cfg: ModelConfig, layer: int) -> Cache:
    """Views of layer ``layer``'s rows of the stacked caches."""
    g, slot = divmod(layer, cfg.group_size)
    c = caches[slot]
    return type(c)(*(t[g] for t in c))


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token: torch.Tensor,
                caches: List[Cache], pos: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """token [B, 1] int; pos [B] int -> (logits f32 [B, vocab], caches).
    The caches are updated in place and returned."""
    h = params["embed"][token].to(cfg.compute_dtype)
    if cfg.pos == "sinusoidal":
        h = h + _sinusoidal_at(pos.to(torch.float32), cfg.d_model
                               )[:, None].to(h.dtype)
    for l, lp in enumerate(params["layers"]):
        mixer, mlp = layer_kinds(cfg, l)
        hn = _norm(cfg, lp["norm1"], h)
        view = _layer_cache(caches, cfg, l)
        if mixer == "attn":
            out, _ = attention_decode(lp["mixer"], cfg.attn_config(), hn,
                                      view, pos)
        else:
            out, nc = ssm_decode(lp["mixer"], cfg.ssm_config(), hn, view)
            view.conv_state.copy_(nc.conv_state)
            view.ssm_state.copy_(nc.ssm_state)
        h, _ = _mlp_block(cfg, lp, mlp, h + out)
        if l % cfg.group_size == cfg.group_size - 1:
            h = _constrain_batch(cfg, h)
    h = _norm(cfg, params["final_norm"], h)
    return logits_from_hidden(params, cfg, h)[:, 0], caches


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, S_max: int,
            cache_dtype=torch.bfloat16,
            vision_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """Run the prompt, returning (last-token logits f32 [B, vocab], primed
    caches). The KV caches are in ``cache_dtype``; an SSM slot's caches are
    what ``_ssm_prefill_state`` gives, as in the reference: the conv state
    in the compute dtype, the SSM state in float32."""
    h = embed_inputs(cfg, params, tokens, vision_embeds)
    B = h.shape[0]
    slots = cfg.group_slots()
    kv = {i: KVCache(*(torch.zeros((cfg.n_groups, B, S_max, cfg.kv_heads,
                                    cfg.hd), dtype=cache_dtype,
                                   device=h.device) for _ in range(2)))
          for i, (mixer, _) in enumerate(slots) if mixer == "attn"}
    ssm_states: Dict[int, List[SSMCache]] = {
        i: [] for i, (mixer, _) in enumerate(slots) if mixer != "attn"}
    for l, lp in enumerate(params["layers"]):
        mixer, mlp = layer_kinds(cfg, l)
        g, slot = divmod(l, cfg.group_size)
        hn = _norm(cfg, lp["norm1"], h)
        if mixer == "attn":
            out, nc = prefill_cache(lp["mixer"], cfg.attn_config(), hn,
                                    S_max, cache_dtype)
            kv[slot].k[g].copy_(nc.k)
            kv[slot].v[g].copy_(nc.v)
        else:
            scfg = cfg.ssm_config()
            out = ssm_forward(lp["mixer"], scfg, hn)
            ssm_states[slot].append(_ssm_prefill_state(lp["mixer"], scfg,
                                                       hn))
        h, _ = _mlp_block(cfg, lp, mlp, h + out)
    h = _norm(cfg, params["final_norm"], h)
    logits = logits_from_hidden(params, cfg, h[:, -1:])[:, 0]
    caches = [kv[i] if i in kv else
              SSMCache(*(torch.stack(t) for t in zip(*ssm_states[i])))
              for i in range(len(slots))]
    return logits, caches


def _ssm_prefill_state(p, scfg: SSMConfig, u: torch.Tensor) -> SSMCache:
    """Final (conv_state, ssm_state) after consuming u (prefill): the
    chunk-free form of the state the chunked scan carries."""
    _, x, Bm, _, dtv, conv_state = _conv_act(p, scfg, u)
    A = -torch.exp(p["A_log"].to(torch.float32))
    cs = torch.cumsum(dtv * A[None, None], dim=1)
    tail = torch.exp(cs[:, -1:] - cs) * dtv
    state = torch.einsum("bjh,bjhp,bjn->bhpn", tail, x, Bm)
    return SSMCache(conv_state, state)
