"""Straggler instrumentation — the port of
``repro.runtime.fault_tolerance.StragglerMonitor``.

The fleet feeds every flush latency to a :class:`StragglerMonitor`
(``Fleet.observe_flush``); a flush slower than ``threshold`` times the
running mean is flagged. The reference's ``Supervisor`` (checkpointed
train-step recovery) comes with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StragglerMonitor:
    """EMA-based step-time anomaly detector: ``observe`` flags a step
    slower than ``threshold`` × the EMA of the steps before it."""
    alpha: float = 0.1
    threshold: float = 2.0
    ema: Optional[float] = None
    slow_steps: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.threshold * self.ema
        self.ema = dt if self.ema is None else \
            (1 - self.alpha) * self.ema + self.alpha * dt
        if slow:
            self.slow_steps.append((step, dt, self.ema))
        return slow


__all__ = ["StragglerMonitor"]
