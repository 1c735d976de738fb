"""Fault tolerance and straggler instrumentation for the train loop (the
port of ``repro.runtime.fault_tolerance``).

``Supervisor`` wraps a step function with periodic async checkpointing,
crash recovery (restore the latest committed checkpoint, replay the
step-keyed data pipeline), heartbeat files (what a cluster manager would
watch) and an EMA step-time straggler detector. The fleet also feeds its
flush latencies to a :class:`StragglerMonitor` (``Fleet.observe_flush``).

The restart path of a real deployment is a new process (``--resume
auto`` picks up the latest commit); the tests run the same logic in one
process by injecting a failure (``fail_at``), which shows that the resume
is bit-exact on the CPU. One difference from the reference: ``finalize``
does not write a step again that the loop's last ``maybe_save`` already
wrote (the same tree, once).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import checkpoint as ckpt


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


@dataclass
class Supervisor:
    ckpt_dir: str
    save_every: int = 50
    keep: int = 3
    heartbeat_path: Optional[str] = None
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    _pending: Optional[Any] = None
    _saved_step: Optional[int] = None

    def resume_step(self) -> int:
        """Step to (re)start from. Checkpoints are labeled with the number
        of completed steps, so the label IS the next step index."""
        last = ckpt.latest_step(self.ckpt_dir)
        return 0 if last is None else last

    def restore(self, target_state):
        """(state, step): the latest committed step loaded into
        ``target_state`` in place, or (None, 0) if there is no
        checkpoint."""
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return None, 0
        return ckpt.restore(self.ckpt_dir, last, target_state), last

    def heartbeat(self, step: int, metrics: Dict):
        if self.heartbeat_path:
            os.makedirs(os.path.dirname(self.heartbeat_path), exist_ok=True)
            tmp = self.heartbeat_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "time": time.time(),
                           "metrics": {k: float(v) for k, v in
                                       metrics.items()}}, f)
            os.replace(tmp, self.heartbeat_path)

    def _save(self, step: int, state, blocking: bool, meta):
        if self._pending is not None:
            self._pending.join()          # backpressure: one in flight
        self._pending = ckpt.save(self.ckpt_dir, step, state,
                                  blocking=blocking, keep=self.keep,
                                  meta=meta or {})
        self._saved_step = step

    def maybe_save(self, step: int, state, *, blocking: bool = False,
                   meta: Optional[Dict] = None):
        if step % self.save_every == 0:
            self._save(step, state, blocking, meta)

    def finalize(self, step: int, state, meta: Optional[Dict] = None):
        if self._saved_step == step:
            self._pending.join()
        else:
            self._save(step, state, True, meta)

    def run(self, state, num_steps: int, step_fn: Callable,
            batch_fn: Callable, start_step: Optional[int] = None,
            fail_at: Optional[int] = None) -> Any:
        """Drive the loop; ``fail_at`` injects a crash (tests)."""
        step = self.resume_step() if start_step is None else start_step
        while step < num_steps:
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(step))
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            self.heartbeat(step, metrics)
            step += 1
            self.maybe_save(step, state)
        self.finalize(step, state)
        return state


__all__ = ["StragglerMonitor", "Supervisor"]
