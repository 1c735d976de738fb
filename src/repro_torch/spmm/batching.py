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
``batcher/served`` counters; with none installed the spans are no-op
singletons. The multi-tenant ``FleetBatcher`` (bounded per-tenant queues,
``QueueFull``) comes with the fleet slice.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.obs import maybe_block, span


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
                 pad_pow2: bool = True, spmm_fn: Optional[SpmmFn] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.matrix = matrix
        self.max_batch = max_batch
        self.impl = impl
        self.pad_pow2 = pad_pow2
        self.spmm_fn = spmm_fn
        self._queue: List[SpmvRequest] = []
        self._next_rid = 0
        self.flushes = 0
        self.served = 0
        # submit and flush may run on different threads
        self._lock = threading.Lock()
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
        a bad request can never poison an already-popped flush batch."""
        x = torch.as_tensor(x)
        n = self.matrix.shape[1]
        if tuple(x.shape) != (n,):
            raise ValueError(
                f"request vector shape {tuple(x.shape)} != matrix n ({n},)")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._queue.append(SpmvRequest(rid, x))
            depth = len(self._queue)
        if obs.enabled():
            self._submit_t[rid] = time.perf_counter()
            reg = obs.current_registry()
            reg.counter("batcher/submitted").inc()
            reg.gauge("batcher/pending").set(depth)
        return rid

    def flush(self) -> Dict[int, torch.Tensor]:
        """Serve up to ``max_batch`` queued requests with one SpMM call and
        scatter the result columns back to their tickets."""
        if not self._queue:
            return {}
        with span("batcher/flush"):
            with self._lock:
                batch, self._queue = (self._queue[:self.max_batch],
                                      self._queue[self.max_batch:])
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
                waits = reg.histogram("batcher/queue_wait_s")
                for r in batch:
                    t0 = self._submit_t.pop(r.rid, None)
                    if t0 is not None:
                        waits.observe(now - t0)
                reg.counter("batcher/flushes").inc()
                reg.counter("batcher/served").inc(k)
                reg.gauge("batcher/batch_k").set(k)
                reg.gauge("batcher/pending").set(len(self._queue))
            return out

    def drain(self) -> Dict[int, torch.Tensor]:
        """Flush until the queue is empty."""
        out: Dict[int, torch.Tensor] = {}
        while self._queue:
            out.update(self.flush())
        return out
