"""Process-local metric registry: counters, gauges, streaming histograms.

The registry is the single sink every instrumented layer writes to —
``obs.trace.span`` phase timings, ``RequestBatcher`` serve telemetry, the
``ResidualLedger`` observed-vs-modeled pairs — and ``dump()`` serializes
all of it as one JSON document (schema ``repro.obs/v1``) so benchmark
gates (``benchmarks.smoke_check``) and humans read the same artifact.

Quantiles come from a bounded reservoir (Vitter's algorithm R with a
deterministic per-series RNG): with ``n <= capacity`` samples the
reservoir IS the full stream, so p50/p95/p99 are *exact* on small N;
past the capacity memory stays bounded and the quantiles are unbiased
estimates. Exactness-on-small-N matters because serve flushes number in
the tens — the SLO percentiles the serve path prints must be real order
statistics, not model output.

Everything here is pure stdlib — importable (and ``install``-able) before
torch, numpy, or any accelerator runtime exists in the process. The
document schema stays ``repro.obs/v1``, the JAX package's, so the same
gates read the port's metrics.

Zero-overhead default: nothing in this module runs unless a registry is
``install()``-ed; instrumented call sites guard on ``enabled()`` /
``current_registry()`` and the disabled path allocates nothing (see
``obs.trace.span`` and the micro-benchmark in ``tests/test_obs.py``).
"""
from __future__ import annotations

import json
import random
import threading
import zlib
from typing import Dict, List, Mapping, Optional, Tuple

# series label values are stringified at record time so a dumped document
# round-trips through JSON without surprises
Labels = Mapping[str, object]

_LOCK = threading.Lock()
_REGISTRY: Optional["MetricRegistry"] = None


def install(registry: "MetricRegistry") -> "MetricRegistry":
    """Make ``registry`` the process-wide sink every instrumented call
    site records into. Returns it (handy for one-liners)."""
    global _REGISTRY
    with _LOCK:
        _REGISTRY = registry
    return registry


def uninstall() -> None:
    """Disable all instrumentation (the default state)."""
    global _REGISTRY
    with _LOCK:
        _REGISTRY = None


def current_registry() -> Optional["MetricRegistry"]:
    return _REGISTRY


def enabled() -> bool:
    """True iff a registry is installed. Hot paths branch on this before
    doing ANY metrics work, so the disabled default costs one global
    load per call site."""
    return _REGISTRY is not None


def _labels_key(labels: Optional[Labels]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic event count (flushes served, requests queued, ...)."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, batch k, ...)."""
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming distribution with bounded memory and exact small-N
    quantiles.

    Reservoir sampling (algorithm R) keeps every sample while
    ``count <= capacity`` — quantiles over that prefix are exact order
    statistics — and an unbiased uniform subsample beyond it. The RNG is
    seeded from the series name so repeated runs of a deterministic
    workload dump identical documents.
    """
    __slots__ = ("name", "labels", "capacity", "count", "total",
                 "min", "max", "_reservoir", "_rng")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.labels = labels
        self.capacity = capacity
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._reservoir: List[float] = []
        # hash() is salted per process; crc32 keeps the seed stable
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float) -> None:
        v = float(v)
        i = self.count
        self.count = i + 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._reservoir) < self.capacity:
            self._reservoir.append(v)
        else:
            j = self._rng.randrange(i + 1)
            if j < self.capacity:
                self._reservoir[j] = v

    @property
    def exact(self) -> bool:
        """True while the reservoir still holds the complete stream."""
        return self.count <= self.capacity

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """Linear-interpolated quantile (numpy's default definition) over
        the reservoir; exact while ``count <= capacity``. None when the
        series is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        s = sorted(self._reservoir)
        n = len(s)
        if n == 0:
            return None
        if n == 1:
            return s[0]
        h = (n - 1) * q
        lo = int(h)
        if lo + 1 >= n:
            return s[-1]
        frac = h - lo
        return s[lo] + frac * (s[lo + 1] - s[lo])

    def percentiles(self, ps=(50, 95, 99)) -> Dict[str, Optional[float]]:
        return {f"p{p:g}": self.quantile(p / 100.0) for p in ps}


class MetricRegistry:
    """Process-local series store. ``base_labels`` (backend, mesh, format,
    ...) stamp every series so one dumped document from a matrixed CI job
    stays attributable.

    >>> reg = install(MetricRegistry(backend="cpu"))
    >>> reg.counter("serve/flushes").inc()
    >>> reg.histogram("serve/flush_s").observe(1e-3)
    >>> reg.dump("metrics.json")
    """

    SCHEMA = "repro.obs/v1"

    def __init__(self, histogram_capacity: int = 1024, **base_labels):
        self.base_labels = {str(k): str(v) for k, v in base_labels.items()}
        self.histogram_capacity = histogram_capacity
        self._lock = threading.Lock()
        self._counters: Dict[Tuple, Counter] = {}
        self._gauges: Dict[Tuple, Gauge] = {}
        self._histograms: Dict[Tuple, Histogram] = {}
        self._ledger = None     # lazy: obs.residuals.ResidualLedger

    def _series(self, store, cls, name: str, labels: Optional[Labels],
                **kw):
        key = (name, _labels_key(labels))
        series = store.get(key)
        if series is None:
            with self._lock:
                series = store.get(key)
                if series is None:
                    series = store[key] = cls(name, key[1], **kw)
        return series

    def counter(self, name: str, labels: Optional[Labels] = None
                ) -> Counter:
        return self._series(self._counters, Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Labels] = None) -> Gauge:
        return self._series(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Labels] = None
                  ) -> Histogram:
        return self._series(self._histograms, Histogram, name, labels,
                            capacity=self.histogram_capacity)

    @property
    def ledger(self):
        """The registry's ``ResidualLedger`` (created on first use) —
        dumped under the ``"residuals"`` key next to the metric series."""
        if self._ledger is None:
            from .residuals import ResidualLedger
            with self._lock:
                if self._ledger is None:
                    self._ledger = ResidualLedger()
        return self._ledger

    def histograms(self) -> List[Histogram]:
        return list(self._histograms.values())

    def as_dict(self) -> dict:
        """The ``repro.obs/v1`` document: every series with merged
        labels, quantile summaries per histogram, and the residual
        ledger's records."""
        def with_labels(series):
            return dict(self.base_labels, **dict(series.labels))

        doc = {
            "schema": self.SCHEMA,
            "labels": dict(self.base_labels),
            "counters": [
                {"name": c.name, "labels": with_labels(c),
                 "value": c.value}
                for c in self._counters.values()],
            "gauges": [
                {"name": g.name, "labels": with_labels(g),
                 "value": g.value}
                for g in self._gauges.values()],
            "histograms": [
                {"name": h.name, "labels": with_labels(h),
                 "count": h.count, "sum": h.total,
                 "min": None if h.count == 0 else h.min,
                 "max": None if h.count == 0 else h.max,
                 "mean": h.mean, "exact": h.exact,
                 **h.percentiles()}
                for h in self._histograms.values()],
            "residuals": ([] if self._ledger is None
                          else self._ledger.as_dicts()),
        }
        return doc

    def dump(self, path: str) -> dict:
        """Serialize the whole registry to ``path`` and return the
        document."""
        doc = self.as_dict()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc
