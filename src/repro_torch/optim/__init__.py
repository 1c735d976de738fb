"""repro_torch.optim — the optimizers and learning-rate schedules (the
port of ``repro.optim``). Schedules take the int32 step tensor and return
a float32 scalar tensor on its device, computed as the reference does."""
from __future__ import annotations

import math
from typing import Callable

import torch

from .adafactor import AdafactorState, adafactor
from .adamw import (AdamWState, Optimizer, adamw, clip_by_global_norm,
                    global_norm)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Callable:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return schedule


def constant_lr(lr: float) -> Callable:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def make_optimizer(name: str, lr_schedule: Callable, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_schedule, **kw)
    if name == "adafactor":
        return adafactor(lr_schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = ["Optimizer", "AdamWState", "AdafactorState", "adamw",
           "adafactor", "warmup_cosine", "constant_lr", "make_optimizer",
           "global_norm", "clip_by_global_norm"]
