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

The expert-parallel dispatches (:func:`moe_apply_ep`,
:func:`moe_apply_ep_tp`) are the reference's ``shard_map`` regions as a
loop over the ambient mesh's positions (``launch.mesh.set_mesh``): each
(batch block, expert rank) pair runs the reference's ``local`` on its
position's device, ``psum`` over the expert axis is a sum of those
outputs on the batch block's first device, and ``pmean`` over the batch
axes a mean of the blocks' routing statistics. The local grouped
products go through :func:`_grouped_matmul`, so with ``use_kernel`` the
mesh launches K9.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.roofline import op_count
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
    dtype of xs and w; rows past ``sum(group_sizes)`` are zero. Reads the
    group sizes on the host. On ``meta`` tensors (no sizes to read) it is
    one product of every row with ``w[0]``: the shape, and the flops and
    gradient flops of the ragged product, for the op counter."""
    dt = torch.promote_types(xs.dtype, w.dtype)
    if xs.is_meta:
        return xs.to(dt) @ w[0].to(dt)
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
    probs, top_e, top_w = _route(xf, p["router"]["w"], k)
    y, group_sizes = _dropless(cfg, xf, top_e, top_w, p["w_gate"],
                               p["w_up"], p["w_down"])

    # switch-style load-balance loss
    frac_tokens = group_sizes.to(torch.float32) / max(T * k, 1)
    mean_prob = probs.mean(dim=0)
    _log_route(cfg, frac_tokens, mean_prob)
    aux = cfg.router_aux_weight * E * torch.sum(frac_tokens * mean_prob)
    return y.reshape(B, S, d).to(x.dtype), aux


def _route(xf: torch.Tensor, router_w: torch.Tensor, k: int):
    """(probs [T, E], top_e [T, k], top_w [T, k]): the router's softmax
    in float32, its top-k experts and their renormalized weights."""
    logits = xf.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # [T, E]
    top_p, top_e = torch.topk(probs, k, dim=-1)                   # [T, k]
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_e, top_w


def _dropless(cfg: MoEConfig, xf, top_e, top_w, w_gate, w_up, w_down):
    """Every (token, slot) pair through its expert: -> (y f32 [T, d],
    group_sizes int32 [E]). ``w_*`` may hold a slice of every expert's
    d_ff (expert-TP), y then a partial sum."""
    T, d = xf.shape
    k = top_e.shape[1]
    # ---- conversion phase: sort (token, slot) pairs by expert ----
    slot_expert = top_e.reshape(-1)                               # [T*k]
    slot_token = torch.arange(T, device=xf.device)[:, None].expand(
        T, k).reshape(-1)
    # stable, as jnp.argsort is: within an expert, slots keep token order
    order = torch.argsort(slot_expert, stable=True)
    tok_sorted = slot_token[order]
    xs = xf[tok_sorted]                                           # [T*k, d]
    # a scatter-add, not bincount: bincount's output length waits on the
    # device (a host sync per layer)
    group_sizes = torch.zeros(w_gate.shape[0], dtype=torch.int32,
                              device=xf.device
                              ).index_add_(0, slot_expert,
                                           torch.ones_like(slot_expert,
                                                           dtype=torch.int32))

    # ---- balanced multiply phase: grouped GEMMs (SwiGLU expert FFN) ----
    g = _grouped_matmul(xs, w_gate, group_sizes, cfg)
    u = _grouped_matmul(xs, w_up, group_sizes, cfg)
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(xs.dtype)
    out_slots = _grouped_matmul(h, w_down, group_sizes, cfg)

    # ---- carry-out fixup: weighted scatter back to tokens ----
    w_sorted = top_w.reshape(-1)[order].to(torch.float32)
    y = torch.zeros((T, d), dtype=torch.float32, device=xf.device)
    y.index_add_(0, tok_sorted, out_slots.to(torch.float32)
                 * w_sorted[:, None])
    return y, group_sizes


_ROUTES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_moe_routes", default=None)


@contextlib.contextmanager
def route_log() -> Iterator[List[Tuple[torch.Tensor, torch.Tensor, float]]]:
    """Inside the block, every MoE call appends ``(frac, mean_prob,
    weight)`` to the yielded list: its tokens' share per expert (no
    gradient), its mean router probabilities and ``router_aux_weight *
    n_experts``, so that ``aux = weight * sum(frac * mean_prob)``. The
    mesh train step reads them to form the aux loss of the whole batch
    from its data blocks."""
    log: List = []
    token = _ROUTES.set(log)
    try:
        yield log
    finally:
        _ROUTES.reset(token)


def _log_route(cfg: MoEConfig, frac: torch.Tensor,
               mean_prob: torch.Tensor) -> None:
    log = _ROUTES.get()
    if log is not None:
        log.append((frac.detach(), mean_prob,
                    cfg.router_aux_weight * cfg.n_experts))


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


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over the ambient mesh
# ---------------------------------------------------------------------------
def _ambient_mesh():
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("expert-parallel dispatch needs an ambient mesh "
                           "(repro_torch.launch.mesh.set_mesh)")
    return mesh


def _blocks(mesh, batch_axes: Tuple[str, ...], ep_axis: str):
    """The distinct (batch block, expert rank) pairs of the mesh's
    positions: ``[(b, group, r, device)]`` with ``b`` the block of the
    batch along the batch axes not fixed by ``at_coords``, ``group`` what
    ``psum`` over ``ep_axis`` sums over (the block's coordinates with the
    expert axis zeroed), ``r`` the expert rank and ``device`` the first
    position's. Returns them and the number of batch blocks."""
    from repro_torch.launch.mesh import local_coords
    from repro_torch.launch.shardings import positions
    names = mesh.axis_names
    size = dict(zip(names, mesh.devices.shape))
    for a in tuple(batch_axes) + (ep_axis,):
        if a not in size:
            raise ValueError(f"axis {a!r} is not in the mesh {names}")
    fixed = local_coords()
    if ep_axis in fixed:
        raise NotImplementedError(
            f"the expert axis {ep_axis!r} carries the batch here: its psum "
            "would sum other data blocks' outputs")
    free = [a for a in batch_axes if a not in fixed]
    seen: Dict[Tuple[int, int], tuple] = {}
    for pos in positions(mesh):
        c = dict(zip(names, pos))
        if any(c[a] != v for a, v in fixed.items() if a in size):
            continue
        b = g = 0
        for a in free:
            b = b * size[a] + c[a]
            g = g * size[a] + (0 if a == ep_axis else c[a])
        key = (b, c[ep_axis])
        if key not in seen:
            seen[key] = (b, g, c[ep_axis], mesh.devices[pos])
    nb = int(np.prod([size[a] for a in free])) if free else 1
    return list(seen.values()), nb, size[ep_axis]


def _ep_slots(cfg: MoEConfig, xf, router_w, ep_rank: int, e_loc: int,
              capacity_factor: float):
    """An expert rank's view of the routing: (probs [T, E], top_w [T, k],
    slot_e [T*k], mine [T*k]: the slots routed to this rank's experts,
    cap: its fixed local capacity, the same on every rank)."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs, top_e, top_w = _route(xf, router_w, k)
    slot_e = top_e.reshape(-1)                           # [T*k]
    mine = (slot_e >= ep_rank * e_loc) & (slot_e < (ep_rank + 1) * e_loc)
    cap = int(capacity_factor * T * k / max(E // e_loc, 1))
    cap = min(max(-(-cap // 128) * 128, 128), T * k)
    return probs, top_w, slot_e, mine, cap


def _ep_local(cfg: MoEConfig, xl, router_w, w_gate, w_up, w_down,
              ep_rank: int, capacity_factor: float):
    """The reference's ``moe_apply_ep`` local: this rank's slots, at a
    fixed capacity, through its experts. -> (y f32 [T, d], frac [E],
    mean_prob [E])."""
    Bl, S, d = xl.shape
    E, k = cfg.n_experts, cfg.top_k
    e_loc = w_gate.shape[0]
    T = Bl * S
    dev = xl.device
    xf = xl.reshape(T, d)
    probs, top_w, slot_e, mine, cap = _ep_slots(cfg, xf, router_w, ep_rank,
                                                e_loc, capacity_factor)
    slot_t = torch.arange(T, device=dev).repeat_interleave(k)
    slot_w = top_w.reshape(-1).to(torch.float32)
    local_e = torch.where(mine, slot_e - ep_rank * e_loc,
                          torch.full_like(slot_e, e_loc))
    order = torch.argsort(torch.where(mine, local_e,
                                      torch.full_like(local_e, e_loc + 1)),
                          stable=True)[:cap]
    sel_e = local_e[order]
    sel_valid = sel_e < e_loc
    tok = slot_t[order]
    xs = xf[tok] * sel_valid[:, None].to(xf.dtype)
    # the reference's scatter drops the out-of-range index e_loc (its
    # update is 0); index_add_ would raise, so those slots add 0 at 0
    group_sizes = torch.zeros(e_loc, dtype=torch.int32, device=dev
                              ).index_add_(0, torch.where(sel_valid, sel_e,
                                                          0),
                                           sel_valid.to(torch.int32))
    g = _grouped_matmul(xs, w_gate, group_sizes, cfg)
    u = _grouped_matmul(xs, w_up, group_sizes, cfg)
    h = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(xs.dtype)
    out = _grouped_matmul(h, w_down, group_sizes, cfg)
    w_sel = slot_w[order] * sel_valid.to(torch.float32)
    y = torch.zeros((T, d), dtype=torch.float32, device=dev).index_add(
        0, tok, out.to(torch.float32) * w_sel[:, None])
    frac = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, slot_e, torch.ones_like(slot_e, dtype=torch.float32)) \
        / max(T * k, 1)
    return y, frac, probs.mean(0)


def _ep_tp_local(cfg: MoEConfig, xl, router_w, w_gate, w_up, w_down):
    """The reference's ``moe_apply_ep_tp`` local: every slot through this
    rank's slice of every expert's d_ff. -> (partial y f32 [T, d], frac,
    mean_prob)."""
    Bl, S, d = xl.shape
    T = Bl * S
    xf = xl.reshape(T, d)
    probs, top_e, top_w = _route(xf, router_w, cfg.top_k)
    y, group_sizes = _dropless(cfg, xf, top_e, top_w, w_gate, w_up, w_down)
    frac = group_sizes.to(torch.float32) / max(T * cfg.top_k, 1)
    return y, frac, probs.mean(0)


def _combine(cfg: MoEConfig, x: torch.Tensor, blocks, results, nb: int):
    """psum of the locals' y over the expert axis on each batch block's
    first device, the blocks joined on x's device; pmean of the routing
    statistics over the batch blocks. -> (y [B, S, d] in x's dtype,
    aux)."""
    B, S, d = x.shape
    Bl = B // nb
    sums: Dict[int, torch.Tensor] = {}
    for (b, g, r, dev), res in zip(blocks, results):
        y = res[0]
        sums[g] = y if g not in sums else sums[g] + y.to(sums[g].device)
        op_count.record_collective("all-reduce",
                                   y.numel() * y.element_size())
    group_of = {b: g for b, g, _, _ in blocks}
    ys = [sums[group_of[b]].reshape(Bl, S, d).to(x.device)
          for b in sorted(group_of)]
    y = torch.cat(ys, 0) if len(ys) > 1 else ys[0]
    # every rank of a block routes the same tokens: the block's stats
    stats = {}
    for (b, g, r, dev), res in zip(blocks, results):
        stats.setdefault(b, (res[1], res[2]))
        if nb > 1:
            op_count.record_collective("all-reduce", 2 * 4 * cfg.n_experts)
    frac = torch.stack([stats[b][0].to(x.device) for b in sorted(stats)]
                       ).mean(0)
    mean_prob = torch.stack([stats[b][1].to(x.device)
                             for b in sorted(stats)]).mean(0)
    _log_route(cfg, frac, mean_prob)
    aux = cfg.router_aux_weight * cfg.n_experts * torch.sum(frac * mean_prob)
    return y.to(x.dtype), aux


def moe_apply_ep(p, cfg: MoEConfig, x: torch.Tensor, *,
                 ep_axis: str = "model",
                 batch_axes: Tuple[str, ...] = ("data",),
                 capacity_factor: float = 1.3
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch over the ambient mesh: experts split over
    ``ep_axis``, the batch over ``batch_axes`` (the axes ``at_coords``
    fixes are already split), the router replicated. Each expert rank
    selects the (token, slot) pairs routed to ITS experts at a fixed
    local capacity (``capacity_factor * T * k / n_ep``, rounded up to 128
    and clipped to ``T * k``; the stable sort puts this rank's slots first
    in token order, so the port drops the reference's slots), runs the
    grouped products locally, and one sum over ``ep_axis`` plays the
    paper's carry-out combine. -> (y [B, S, d], aux); the slots it drops
    are counted by :func:`ep_dropped_slots`."""
    mesh = _ambient_mesh()
    B, S, d = x.shape
    E = cfg.n_experts
    blocks, nb, n_ep = _blocks(mesh, tuple(batch_axes), ep_axis)
    if B % nb or E % n_ep:
        raise ValueError(f"batch {B} over {nb} blocks and {E} experts over "
                         f"{n_ep} ranks must divide")
    Bl, e_loc = B // nb, E // n_ep

    def args_of(blk):
        b, _, r, dev = blk
        sl = slice(r * e_loc, (r + 1) * e_loc)
        return (x[b * Bl:(b + 1) * Bl].to(dev), p["router"]["w"].to(dev),
                p["w_gate"][sl].to(dev), p["w_up"][sl].to(dev),
                p["w_down"][sl].to(dev))

    # on meta the positions' ops are equal: op_count runs the first for all
    results = op_count.equal_calls(
        lambda blk, *xs: _ep_local(cfg, *xs, blk[2], capacity_factor),
        blocks, args_of)
    return _combine(cfg, x, blocks, results, nb)


def ep_dropped_slots(p, cfg: MoEConfig, x: torch.Tensor, *,
                     ep_axis: str = "model",
                     batch_axes: Tuple[str, ...] = ("data",),
                     capacity_factor: float = 1.3) -> int:
    """The (token, slot) pairs :func:`moe_apply_ep` drops on the ambient
    mesh with these arguments: each expert rank's slots past its fixed
    capacity, summed over the ranks (the reference computes this count
    and discards it)."""
    mesh = _ambient_mesh()
    B, S, d = x.shape
    blocks, nb, n_ep = _blocks(mesh, tuple(batch_axes), ep_axis)
    Bl, e_loc = B // nb, cfg.n_experts // n_ep
    dropped = 0
    for b, _, r, dev in blocks:
        xf = x[b * Bl:(b + 1) * Bl].reshape(Bl * S, d).to(dev)
        *_, mine, cap = _ep_slots(cfg, xf, p["router"]["w"].to(dev), r,
                                  e_loc, capacity_factor)
        dropped += max(int(mine.sum()) - cap, 0)
    return dropped


def moe_apply_ep_tp(p, cfg: MoEConfig, x: torch.Tensor, *,
                    ep_axis: str = "model",
                    batch_axes: Tuple[str, ...] = ("data",)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-TP dispatch for archs whose expert count does NOT divide the
    model axis: every rank holds a 1/n_ep slice of EVERY expert's d_ff,
    the dispatch runs fully locally and losslessly, and the partial
    w_down outputs are summed over the axis. -> (y [B, S, d], aux)."""
    mesh = _ambient_mesh()
    B, S, d = x.shape
    f = p["w_gate"].shape[2]
    blocks, nb, n_ep = _blocks(mesh, tuple(batch_axes), ep_axis)
    if B % nb or f % n_ep:
        raise ValueError(f"batch {B} over {nb} blocks and d_ff {f} over "
                         f"{n_ep} ranks must divide")
    Bl, f_loc = B // nb, f // n_ep

    def args_of(blk):
        b, _, r, dev = blk
        sl = slice(r * f_loc, (r + 1) * f_loc)
        return (x[b * Bl:(b + 1) * Bl].to(dev), p["router"]["w"].to(dev),
                p["w_gate"][:, :, sl].to(dev), p["w_up"][:, :, sl].to(dev),
                p["w_down"][:, sl].to(dev))

    results = op_count.equal_calls(lambda blk, *xs: _ep_tp_local(cfg, *xs),
                                   blocks, args_of)
    return _combine(cfg, x, blocks, results, nb)
