"""AdamW with global-norm clipping (the port of ``repro.optim.adamw``).

The reference's optimizers are pure functions over parameter pytrees.
Here ``update`` writes the parameters and the optimizer state in place
(no second copy of either on the card) and returns them, with the
reference's signature: ``update(grads, state, params) -> (params, state,
metrics)``. ``grads`` is a sequence aligned with ``leaves(params)``. A
checkpoint copies the state to the host
before ``checkpoint.save`` returns, so a later in-place update cannot
reach a save that is still being written.

A parameter tree is a module (its ``named_parameters``; a tree with
``leaf_stacks``, the LM's ``ParamTree``, gives its layers' leaves stacked
over groups as the reference stores them), a dict of tensors or trees, or
a list of tensors. Scalars follow the reference's float32 arithmetic:
the step count is an int32 tensor and every rate and bias correction is
computed from it in float32.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
from torch import nn


def leaf_stacks(tree: Any) -> List[Tuple[str, List[torch.Tensor], bool]]:
    """``[(name, tensors, stacked)]``: the leaves of the reference's tree
    in a fixed order. A leaf stacked over groups (``stacked``) lists its
    tensors in group order, as the reference's ``[n_groups, ...]`` leaf
    holds them; any other leaf is one tensor."""
    if hasattr(tree, "leaf_stacks"):
        return tree.leaf_stacks()
    if isinstance(tree, nn.Module):
        return [(n, [p], False) for n, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [("", [tree], False)]
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        raise TypeError(f"not a parameter tree: {type(tree).__name__}")
    out = []
    for k, v in items:
        for name, ts, stacked in leaf_stacks(v):
            out.append((f"{k}.{name}" if name else k, ts, stacked))
    return out


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``leaf_stacks`` order (a stack's tensors
    in group order): the order ``grads`` follow."""
    return [t for _, ts, _ in leaf_stacks(tree) for t in ts]


def _grads_list(grads: Sequence[torch.Tensor], params
                ) -> List[torch.Tensor]:
    n = len(leaves(params))
    if len(grads) != n:
        raise ValueError(f"{len(grads)} gradients for {n} parameters")
    return list(grads)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    ts = tree if isinstance(tree, (list, tuple)) else leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in ts))


def clip_by_global_norm(tree, max_norm: float):
    """(the leaves scaled by min(1, max_norm / norm), norm). Returns new
    tensors, a list aligned with ``leaves(tree)``."""
    ts = tree if isinstance(tree, (list, tuple)) else leaves(tree)
    norm = global_norm(ts)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in ts], norm


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: List[torch.Tensor]       # float32, aligned with leaves(params)
    v: List[torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (grads, state, params) -> (params, state, metrics)


def f32_scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device (a Python float in a
    JAX expression is rounded to float32 where it meets a float32 array)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw(lr_schedule: Callable[[torch.Tensor], torch.Tensor],
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: Optional[float] = 1.0
          ) -> Optimizer:
    def init(params) -> AdamWState:
        ps = leaves(params)
        dev = ps[0].device if ps else None
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=[zeros(p) for p in ps], v=[zeros(p) for p in ps])

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        ps = leaves(params)
        gs = _grads_list(grads, params)
        grad_norm = global_norm(gs)
        if clip_norm is not None:
            gs, _ = clip_by_global_norm(gs, clip_norm)
        step = state.step + 1
        lr = lr_schedule(step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(f32_scalar(b1, stepf), stepf)
        b2c = 1 - torch.pow(f32_scalar(b2, stepf), stepf)
        for p, g, m, v in zip(ps, gs, state.m, state.v):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + eps) \
                + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        return params, AdamWState(step, state.m, state.v), \
            {"lr": lr, "grad_norm": grad_norm}

    return Optimizer(init, update)


__all__ = ["AdamWState", "Optimizer", "adamw", "global_norm",
           "clip_by_global_norm", "leaf_stacks", "leaves"]
