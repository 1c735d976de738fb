"""Request batching: many single-vector SpMV requests -> one SpMM call.

Each user request is one ``A @ x`` — memory-bound, wasting the matrix
stream on a single vector. Aggregating queued requests into a ``[n, k]``
block before multiplying reuses every streamed nonzero k times at zero
cost to correctness: column j of the SpMM is request j's SpMV.

``RequestBatcher`` is the queueing front end ``launch.serve`` drives; k is
padded to the next power of two (capped at ``max_batch``) so a server sees
O(log max_batch) distinct batch shapes.

Serve metrics (``repro_torch.obs``): with a registry installed every flush
records ``batcher/flush`` (whole flush, synchronized so the latency is
real), ``batcher/pad``, ``batcher/multiply`` and ``batcher/scatter``, a
``batcher/queue_wait_s`` histogram and the ``batcher/flushes`` /
``batcher/served`` counters, each labelled with the batcher's tenant
``name`` when it has one; with none installed the spans are no-op
singletons. ``max_pending`` bounds a queue: a submit past it raises
:class:`QueueFull` (``overflow="raise"``) or waits for a flush
(``"block"``).

``FleetBatcher`` is the multi-tenant front end of ``serve --mode fleet``:
one ``RequestBatcher`` lane per tenant and one flush scheduler across
them (SLO urgency × batch efficiency).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.obs import maybe_block, span


class QueueFull(RuntimeError):
    """A ``submit`` hit the tenant's ``max_pending`` bound under the
    ``overflow="raise"`` policy; carries what a caller needs to shed load
    (retry later, send to another replica)."""

    def __init__(self, tenant: Optional[str], pending: int,
                 max_pending: int):
        self.tenant = tenant
        self.pending = pending
        self.max_pending = max_pending
        who = f"tenant {tenant!r}" if tenant else "batcher"
        super().__init__(
            f"{who} queue full: {pending} pending >= max_pending="
            f"{max_pending}")


# Pluggable SpMM: (matrix, X[n, k]) -> Y[m, k].
SpmmFn = Callable[[object, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SpmvRequest:
    """One queued ``A @ x`` request."""
    rid: int
    x: torch.Tensor


def _next_pow2(k: int) -> int:
    p = 1
    while p < k:
        p <<= 1
    return p


def _result_dtype(xs) -> torch.dtype:
    """Promotion over every request: one low-precision request must not
    downcast its neighbours' columns."""
    return functools.reduce(torch.promote_types, (x.dtype for x in xs))


def batch_spmv(matrix, requests: Sequence, *, impl: str = "auto",
               k_tile: Optional[int] = None,
               spmm_fn: Optional[SpmmFn] = None) -> List[torch.Tensor]:
    """Answer a batch of single-vector requests with ONE SpMM; returns the
    per-request results in input order."""
    from . import spmm
    if not requests:
        return []
    xs = [r.x if isinstance(r, SpmvRequest) else r for r in requests]
    n = matrix.shape[1]
    for x in xs:
        if tuple(x.shape) != (n,):
            raise ValueError(
                f"request vector shape {tuple(x.shape)} != matrix n ({n},)")
    dtype = _result_dtype(xs)
    X = torch.stack([x.to(dtype) for x in xs], dim=1)       # [n, k]
    if spmm_fn is not None:
        Y = spmm_fn(matrix, X)
    else:
        Y = spmm(matrix, X, impl=impl, k_tile=k_tile)
    return [Y[:, j] for j in range(len(xs))]


class RequestBatcher:
    """Aggregates queued SpMV requests and answers them with one SpMM.

    >>> b = RequestBatcher(matrix, max_batch=64)
    >>> rid = b.submit(x)            # enqueue, returns a ticket
    >>> results = b.flush()          # one SpMM; {rid: y}
    """

    def __init__(self, matrix, *, max_batch: int = 128, impl: str = "auto",
                 pad_pow2: bool = True, spmm_fn: Optional[SpmmFn] = None,
                 max_pending: Optional[int] = None,
                 overflow: str = "raise", name: Optional[str] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        if overflow not in ("raise", "block"):
            raise ValueError(
                f"overflow must be 'raise' or 'block', got {overflow!r}")
        self.matrix = matrix
        self.max_batch = max_batch
        self.impl = impl
        self.pad_pow2 = pad_pow2
        self.spmm_fn = spmm_fn
        self.max_pending = max_pending
        self.overflow = overflow
        self.name = name
        # every series this batcher emits carries its tenant label, so a
        # fleet's lanes stay apart in one registry
        self._labels = {"tenant": name} if name is not None else None
        self._queue: List[SpmvRequest] = []
        self._next_rid = 0
        self.flushes = 0
        self.served = 0
        self.rejected = 0
        # submit and flush may run on different threads; "block"
        # submitters wait here until a flush makes room
        self._cond = threading.Condition()
        # submit timestamps for the queue-wait histogram; only written
        # while an obs registry is installed
        self._submit_t: Dict[int, float] = {}

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def submit(self, x: torch.Tensor) -> int:
        """Enqueue one request; returns its ticket id. Shape-checked here so
        a bad request can never poison an already-popped flush batch.

        With ``max_pending`` set, a submit that would pass the bound
        raises :class:`QueueFull` (``overflow="raise"``, counted in
        ``rejected`` and ``batcher/rejected``) or waits until a flush makes
        room (``overflow="block"``)."""
        x = torch.as_tensor(x)
        n = self.matrix.shape[1]
        if tuple(x.shape) != (n,):
            raise ValueError(
                f"request vector shape {tuple(x.shape)} != matrix n ({n},)")
        with self._cond:
            if self.max_pending is not None:
                if self.overflow == "block":
                    self._cond.wait_for(
                        lambda: len(self._queue) < self.max_pending)
                elif len(self._queue) >= self.max_pending:
                    self.rejected += 1
                    if obs.enabled():
                        obs.current_registry().counter(
                            "batcher/rejected", self._labels).inc()
                    raise QueueFull(self.name, len(self._queue),
                                    self.max_pending)
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append(SpmvRequest(rid, x))
            depth = len(self._queue)
        if obs.enabled():
            self._submit_t[rid] = time.perf_counter()
            reg = obs.current_registry()
            reg.counter("batcher/submitted", self._labels).inc()
            reg.gauge("batcher/pending", self._labels).set(depth)
        return rid

    def flush(self) -> Dict[int, torch.Tensor]:
        """Serve up to ``max_batch`` queued requests with one SpMM call and
        scatter the result columns back to their tickets."""
        if not self._queue:
            return {}
        with span("batcher/flush"):
            with self._cond:
                batch, self._queue = (self._queue[:self.max_batch],
                                      self._queue[self.max_batch:])
                # room opened up: wake "block" submitters
                self._cond.notify_all()
            k = len(batch)
            n = self.matrix.shape[1]
            kp = min(_next_pow2(k), self.max_batch) if self.pad_pow2 else k
            with span("batcher/pad"):
                dtype = _result_dtype(r.x for r in batch)
                X = torch.zeros((n, kp), dtype=dtype,
                                device=batch[0].x.device)
                X[:, :k] = torch.stack([r.x.to(dtype) for r in batch], dim=1)
                maybe_block(X)
            with span("batcher/multiply"):
                if self.spmm_fn is not None:
                    Y = self.spmm_fn(self.matrix, X)
                else:
                    from . import spmm
                    Y = spmm(self.matrix, X, impl=self.impl)
                maybe_block(Y)
            with span("batcher/scatter"):
                out = {r.rid: Y[:, j] for j, r in enumerate(batch)}
            self.flushes += 1
            self.served += k
            if obs.enabled():
                reg = obs.current_registry()
                now = time.perf_counter()
                waits = reg.histogram("batcher/queue_wait_s", self._labels)
                for r in batch:
                    t0 = self._submit_t.pop(r.rid, None)
                    if t0 is not None:
                        waits.observe(now - t0)
                reg.counter("batcher/flushes", self._labels).inc()
                reg.counter("batcher/served", self._labels).inc(k)
                reg.gauge("batcher/batch_k", self._labels).set(k)
                reg.gauge("batcher/pending",
                          self._labels).set(len(self._queue))
            return out

    def drain(self) -> Dict[int, torch.Tensor]:
        """Flush until the queue is empty."""
        out: Dict[int, torch.Tensor] = {}
        while self._queue:
            out.update(self.flush())
        return out


@dataclasses.dataclass
class _TenantLane:
    """One tenant's queue and SLO bookkeeping inside a
    :class:`FleetBatcher`."""
    name: str
    batcher: RequestBatcher
    slo_s: float
    arrivals: "collections.deque[float]" = dataclasses.field(
        default_factory=collections.deque)
    served: int = 0
    flushes: int = 0
    slo_violations: int = 0


class FleetBatcher:
    """Multi-tenant front end: one :class:`RequestBatcher` lane per tenant,
    one flush scheduler across them.

    ``next_tenant`` scores every lane with pending work by SLO urgency ×
    batch efficiency:

    ``score = (age_oldest / slo_s) * (min(pending, max_batch) / max_batch)``

    The first factor passes 1.0 as the lane's oldest request reaches its
    latency budget, so an old request wins however small its batch (no
    starvation); the second prefers full batches, which reuse every
    streamed nonzero k times. Ties go to the older oldest arrival.
    ``flush_next`` and ``drain`` never drop a request.

    Per-lane bounds (``max_pending``, ``overflow``) ride on the lane's
    :class:`RequestBatcher`; every series a lane emits carries its
    ``tenant`` label, and late requests land in ``fleet/slo_violations``.
    ``clock`` is injectable for deterministic scheduler tests."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter):
        self._lanes: Dict[str, _TenantLane] = {}
        self._clock = clock

    def add_tenant(self, name: str, op, *, max_batch: int = 128,
                   slo_s: float = 0.1, max_pending: Optional[int] = None,
                   overflow: str = "raise",
                   spmm_fn: Optional[SpmmFn] = None) -> _TenantLane:
        """Register a lane over ``op`` (anything with ``matmul``, such as a
        :class:`repro_torch.spmm.SparseOperator`, or a raw matrix when
        ``spmm_fn`` is given)."""
        if name in self._lanes:
            raise ValueError(f"tenant {name!r} already registered")
        if slo_s <= 0:
            raise ValueError("slo_s must be > 0")
        if spmm_fn is None:
            spmm_fn = lambda _m, X: op.matmul(X)
        batcher = RequestBatcher(
            op, max_batch=max_batch, spmm_fn=spmm_fn,
            max_pending=max_pending, overflow=overflow, name=name)
        lane = _TenantLane(name, batcher, float(slo_s))
        self._lanes[name] = lane
        return lane

    def tenants(self) -> List[str]:
        return list(self._lanes)

    def lane(self, name: str) -> _TenantLane:
        return self._lanes[name]

    def submit(self, tenant: str, x: torch.Tensor) -> int:
        """Enqueue one request on ``tenant``'s lane (its bound applies);
        the arrival time feeds the scheduler."""
        lane = self._lanes[tenant]
        rid = lane.batcher.submit(x)     # QueueFull raises before this
        lane.arrivals.append(self._clock())
        return rid

    @property
    def total_pending(self) -> int:
        return sum(lane.batcher.pending for lane in self._lanes.values())

    def next_tenant(self, now: Optional[float] = None) -> Optional[str]:
        """The lane with the highest urgency × efficiency score, or None
        when nothing is pending."""
        if now is None:
            now = self._clock()
        best = None
        best_key: Optional[Tuple[float, float]] = None
        for name, lane in self._lanes.items():
            pending = lane.batcher.pending
            if not pending:
                continue
            oldest = lane.arrivals[0] if lane.arrivals else now
            urgency = (now - oldest) / lane.slo_s
            mb = lane.batcher.max_batch
            efficiency = min(pending, mb) / mb
            key = (urgency * efficiency, now - oldest)
            if best_key is None or key > best_key:
                best, best_key = name, key
        return best

    def flush(self, tenant: str) -> Dict[int, torch.Tensor]:
        """Flush one batch from ``tenant``'s lane; counts the requests
        that waited past the lane's SLO."""
        lane = self._lanes[tenant]
        out = lane.batcher.flush()
        k = len(out)
        if k:
            now = self._clock()
            late = 0
            for _ in range(k):
                t0 = lane.arrivals.popleft()
                if now - t0 > lane.slo_s:
                    late += 1
            lane.served += k
            lane.flushes += 1
            if late:
                lane.slo_violations += late
                if obs.enabled():
                    obs.current_registry().counter(
                        "fleet/slo_violations",
                        {"tenant": tenant}).inc(late)
        return out

    def flush_next(self) -> Tuple[Optional[str], Dict[int, torch.Tensor]]:
        """One scheduler step: flush the lane ``next_tenant`` picks;
        ``(None, {})`` when every lane is empty."""
        tenant = self.next_tenant()
        if tenant is None:
            return None, {}
        return tenant, self.flush(tenant)

    def drain(self) -> Dict[str, Dict[int, torch.Tensor]]:
        """Flush, in scheduler order, until every lane is empty."""
        out: Dict[str, Dict[int, torch.Tensor]] = {
            t: {} for t in self._lanes}
        while self.total_pending:
            tenant, res = self.flush_next()
            if tenant is None:
                break
            out[tenant].update(res)
        return out
