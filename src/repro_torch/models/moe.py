"""Mixture-of-Experts FFN with dropless, sort-based dispatch (the port of
``repro.models.moe``).

The token->expert assignment is an unstructured sparse matrix whose row
lengths (tokens per expert) are as skewed as a power-law graph's degrees.
Dispatch = sort tokens by expert (the conversion phase) + grouped GEMM
over equal-cost tiles (the balanced multiply phase). Two compute paths,
as in the reference:

  * ``use_kernel=False``: a product per expert over its group's rows (the
    counterpart of ``jax.lax.ragged_dot``);
  * ``use_kernel=True``: ``repro_torch.kernels.ops.moe_group_matmul`` —
    K9 on CUDA tensors, its plain version on CPU tensors or with
    ``plain=True`` (the counterpart of the reference's interpret mode).

The expert-parallel dispatches (``moe_apply_ep``/``moe_apply_ep_tp``,
``shard_map`` over an EP axis) come with the LM mesh slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, normal


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    use_kernel: bool = False  # grouped-GEMM kernel (K9) instead of per-expert
    router_aux_weight: float = 0.01
    plain: bool = False       # with use_kernel: K9's plain version anywhere


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32):
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "router": dense_init(gen, d, E, dtype=dtype),
        "w_gate": normal(gen, (E, d, f), dtype, s_in),
        "w_up": normal(gen, (E, d, f), dtype, s_in),
        "w_down": normal(gen, (E, f, d), dtype, s_out),
    }


def _ragged_dot(xs: torch.Tensor, w: torch.Tensor,
                group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot``: rows of group e times w[e], in the promoted
    dtype of xs and w. Reads the group sizes on the host."""
    dt = torch.promote_types(xs.dtype, w.dtype)
    out = torch.zeros((xs.shape[0], w.shape[2]), dtype=dt, device=xs.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = xs[start:start + n].to(dt) @ w[e].to(dt)
        start += n
    return out


def _grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                    group_sizes: torch.Tensor, cfg: MoEConfig
                    ) -> torch.Tensor:
    if cfg.use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.moe_group_matmul(xs, w, group_sizes, plain=cfg.plain)
    return _ragged_dot(xs, w, group_sizes)


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    T = B * S
    k = cfg.top_k
    E = cfg.n_experts
    xf = x.reshape(T, d)

    logits = xf.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # [T, E]
    top_p, top_e = torch.topk(probs, k, dim=-1)                   # [T, k]
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- conversion phase: sort (token, slot) pairs by expert ----
    slot_expert = top_e.reshape(-1)                               # [T*k]
    slot_token = torch.arange(T, device=x.device)[:, None].expand(
        T, k).reshape(-1)
    # stable, as jnp.argsort is: within an expert, slots keep token order
    order = torch.argsort(slot_expert, stable=True)
    tok_sorted = slot_token[order]
    xs = xf[tok_sorted]                                           # [T*k, d]
    # a scatter-add, not bincount: bincount's output length waits on the
    # device (a host sync per layer)
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device
                              ).index_add_(0, slot_expert,
                                           torch.ones_like(slot_expert,
                                                           dtype=torch.int32))

    # ---- balanced multiply phase: grouped GEMMs (SwiGLU expert FFN) ----
    g = _grouped_matmul(xs, p["w_gate"], group_sizes, cfg)
    u = _grouped_matmul(xs, p["w_up"], group_sizes, cfg)
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(xs.dtype)
    out_slots = _grouped_matmul(h, p["w_down"], group_sizes, cfg)

    # ---- carry-out fixup: weighted scatter back to tokens ----
    w_sorted = top_w.reshape(-1)[order].to(torch.float32)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok_sorted, out_slots.to(torch.float32)
                 * w_sorted[:, None])

    # switch-style load-balance loss
    frac_tokens = group_sizes.to(torch.float32) / max(T * k, 1)
    mean_prob = probs.mean(dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(frac_tokens * mean_prob)
    return y.reshape(B, S, d).to(x.dtype), aux


def expert_load_stats(p, cfg: MoEConfig, x: torch.Tensor) -> dict:
    """Routing imbalance diagnostics (max/mean tokens per expert etc.) —
    the MoE analogue of the paper's nnz-per-row variance."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    logits = xf.to(torch.float32) @ p["router"]["w"].to(torch.float32)
    _, top_e = torch.topk(torch.softmax(logits, -1), cfg.top_k, dim=-1)
    counts = torch.bincount(top_e.reshape(-1),
                            minlength=cfg.n_experts).to(torch.int32)
    mean = counts.to(torch.float32).mean()
    return {"counts": counts,
            "max_over_mean": counts.max() / torch.clamp(mean, min=1),
            "variance": counts.to(torch.float32).var(unbiased=False)}
