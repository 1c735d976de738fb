"""Train and serve step builders (the port of the step half of
``repro.launch.steps``). The reference's abstract input specs, sharded
train states and per-cell lowering (``abstract_params``,
``abstract_train_state``, ``input_specs``, ``cell_config``,
``lower_cell``) belong to the LM mesh slice (ROADMAP.md queue 1 item 5).

A step runs eagerly on the parameters' device. ``train_step`` updates the
parameters and the optimizer state in place and returns them in a new
``TrainState`` with the metrics (float32 scalar tensors).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models.model import (ModelConfig, decode_step, loss_fn,
                                      prefill)
from repro_torch.optim import Optimizer, make_optimizer, warmup_cosine
from repro_torch.optim.adamw import leaves


class TrainState(NamedTuple):
    params: Any
    opt: Any


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    # jamba-398B cannot hold AdamW state: factored second moments there
    name = "adafactor" if cfg.d_model >= 8192 else "adamw"
    return make_optimizer(name, warmup_cosine(3e-4, 2000, 100_000))


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d leaves(params); zeros for a leaf the loss does not use
    (as ``jax.grad`` gives)."""
    ps = leaves(params)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(ps, gs)]


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    grad_accum: int = 1):
    """Train step; grad_accum > 1 splits the batch into microbatches and
    sums their float32 gradients before one optimizer update (activation
    memory scales 1/n_micro). MoE layers train through the per-expert
    route: K9 has no backward (as in the reference, whose Pallas kernel
    has none)."""
    if cfg.moe_use_kernel:
        raise NotImplementedError("K9 (moe_use_kernel) has no backward: "
                                  "train with moe_use_kernel=False")

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        vis = batch.get("vision_embeds")
        params = state.params
        if grad_accum == 1:
            loss, metrics = loss_fn(params, cfg, tokens, vision_embeds=vis)
            grads = _grads(loss, params)
            loss = loss.detach()
            ce, aux = metrics["ce"].detach(), metrics["aux"].detach()
        else:
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            mb = B // grad_accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            zero = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            l_sum, ce_sum, aux_sum = zero, zero, zero
            for i in range(grad_accum):
                t = tokens[i * mb:(i + 1) * mb]
                v = None if vis is None else vis[i * mb:(i + 1) * mb]
                l, m = loss_fn(params, cfg, t, vision_embeds=v)
                for acc, g in zip(grads, _grads(l, params)):
                    acc.add_(g)
                l_sum = l_sum + l.detach()
                ce_sum = ce_sum + m["ce"].detach()
                aux_sum = aux_sum + m["aux"].detach()
            inv = 1.0 / grad_accum
            grads = [g * inv for g in grads]
            loss, ce, aux = l_sum * inv, ce_sum * inv, aux_sum * inv

        params, opt, om = optimizer.update(grads, state.opt, params)
        out = {"loss": loss, "ce": ce, "aux": aux, **om}
        return TrainState(params, opt), out

    return train_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, caches, token, pos):
        return decode_step(params, cfg, token, caches, pos)
    return serve_step


def make_prefill(cfg: ModelConfig, S_max: int):
    def prefill_step(params, tokens, vision_embeds=None):
        return prefill(params, cfg, tokens, S_max,
                       vision_embeds=vision_embeds)
    return prefill_step


__all__ = ["TrainState", "default_optimizer", "make_train_step",
           "make_decode_step", "make_prefill"]
