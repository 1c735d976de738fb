"""repro_torch.obs — observability for the SpMM serving stack.

  ``metrics``    process-local ``MetricRegistry``: counters, gauges,
                 reservoir histograms (exact p50/p95/p99 on small N),
                 JSON ``dump()`` as a ``repro.obs/v1`` document
  ``trace``      ``span("name")`` phase tracing — host wall time into the
                 registry + ``torch.profiler.record_function`` / NVTX
  ``residuals``  ``ResidualLedger``: observed-vs-modeled pairings
  ``timing``     the paper's §5.2 min-of-N protocol, CUDA-synchronized

Default state is OFF: until ``install(MetricRegistry(...))`` runs, every
instrumented call site is a no-op.
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricRegistry,
                      current_registry, enabled, install, uninstall)
from .residuals import ResidualLedger, ResidualRecord, choice_labels
from .timing import TimingResult, time_min_of_n
from .trace import maybe_block, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "current_registry", "enabled", "install", "uninstall",
    "ResidualLedger", "ResidualRecord", "choice_labels",
    "TimingResult", "time_min_of_n",
    "maybe_block", "span",
]
