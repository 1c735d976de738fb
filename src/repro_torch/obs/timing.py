"""The min-of-N timing protocol (the paper's §5.2: time many executions,
report the minimum — on a memory-bound kernel the minimum is the
reproducible number).

CUDA work is asynchronous, so with ``block=True`` each rep synchronizes
the device before the clock starts and after ``fn`` returns whenever its
output holds a CUDA tensor: the row times execution, not the enqueue.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch

from .trace import _on_cuda


class TimingResult(NamedTuple):
    """One min-of-N measurement plus the protocol that produced it."""
    best_s: float          # minimum wall seconds over the timed reps
    reps: int
    warmup: int
    last_result: Any       # fn's return value from the final rep


def _sync(out) -> None:
    if _on_cuda(out):
        torch.cuda.synchronize()


def time_min_of_n(fn: Callable, *args, reps: int = 20, warmup: int = 3,
                  block: bool = True) -> TimingResult:
    """Min wall seconds of ``fn(*args)`` over ``reps`` timed runs after
    ``warmup`` untimed ones."""
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    if warmup < 0:
        raise ValueError(f"warmup must be >= 0, got {warmup}")
    out = None
    for _ in range(warmup):
        out = fn(*args)
        if block:
            _sync(out)
    best = float("inf")
    for _ in range(reps):
        if block and torch.cuda.is_available() and \
                torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if block:
            _sync(out)
        best = min(best, time.perf_counter() - t0)
    return TimingResult(best, reps, warmup, out)
