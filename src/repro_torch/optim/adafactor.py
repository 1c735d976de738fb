"""Adafactor [Shazeer & Stern 2018]: factored second moments, no momentum
(the port of ``repro.optim.adafactor``).

Selected for the largest configs (jamba-398B), where AdamW's 8 bytes per
parameter of optimizer state is too much; factored state is O(rows +
cols) per matrix.

The reference stores every layer leaf stacked over the model's groups
(``[n_groups, ...]``) and factors every leaf of two or more dimensions.
So it factors a per-layer vector (a norm scale, a bias, ``A_log``) across
the layers once there are two groups or more, and clips each update's RMS
over the whole stack. The port keeps that: it updates each entry of
``leaf_stacks(params)`` as one stacked tensor, and its state holds the
stacked factors.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch

from .adamw import (Optimizer, _grads_list, clip_by_global_norm,
                    f32_scalar, global_norm, leaf_stacks)


class AdafactorState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    vr: List[torch.Tensor]      # row second moment (or full v for <2D)
    vc: List[torch.Tensor]      # col second moment ([1] zeros for <2D)


def adafactor(lr_schedule: Callable, decay: float = 0.8,
              eps: float = 1e-30, clip_norm: Optional[float] = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    def init(params) -> AdafactorState:
        vr, vc = [], []
        for _, ts, stacked in leaf_stacks(params):
            shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            dev = ts[0].device
            factored = len(shape) >= 2
            vr.append(torch.zeros(shape[:-1] if factored else shape,
                                  dtype=torch.float32, device=dev))
            vc.append(torch.zeros(shape[:-2] + shape[-1:] if factored
                                  else (1,), dtype=torch.float32,
                                  device=dev))
        dev = vr[0].device if vr else None
        return AdafactorState(torch.zeros((), dtype=torch.int32,
                                          device=dev), vr, vc)

    @torch.no_grad()
    def update(grads, state: AdafactorState, params):
        gs = _grads_list(grads, params)
        grad_norm = global_norm(gs)
        if clip_norm is not None:
            gs, _ = clip_by_global_norm(gs, clip_norm)
        step = state.step + 1
        lr = lr_schedule(step)
        stepf = step.to(torch.float32)
        beta = 1.0 - torch.pow(stepf, f32_scalar(-decay, stepf))
        i = 0
        for (_, ts, stacked), vr, vc in zip(leaf_stacks(params), state.vr,
                                            state.vc):
            g_parts = gs[i:i + len(ts)]
            i += len(ts)
            p = torch.stack(ts) if stacked else ts[0]
            g = (torch.stack(g_parts) if stacked else g_parts[0]
                 ).to(torch.float32)
            g2 = g * g + eps
            if vr.dim() < p.dim():                       # factored
                vr.copy_(beta * vr + (1 - beta) * g2.mean(dim=-1))
                vc.copy_(beta * vc + (1 - beta) * g2.mean(dim=-2))
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
                precond = (vr[..., None] / denom[..., None]) \
                    * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(precond, min=eps))
            else:
                vr.copy_(beta * vr + (1 - beta) * g2)
                u = g * torch.rsqrt(torch.clamp(vr, min=eps))
            # update clipping (RMS <= 1), per the paper
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms, min=1.0)
            newp = (p.to(torch.float32) - lr * (
                u + weight_decay * p.to(torch.float32))).to(p.dtype)
            if stacked:
                for t, n in zip(ts, newp):
                    t.copy_(n)
            else:
                p.copy_(newp)
        return params, AdafactorState(step, state.vr, state.vc), \
            {"lr": lr, "grad_norm": grad_norm}

    return Optimizer(init, update)


__all__ = ["AdafactorState", "adafactor"]
