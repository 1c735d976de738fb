"""The closed loop of independent clients, driven from one thread.

Each client submits one request, waits until its answer is complete on
the device, and then submits its next. The harness flushes whatever is
queued, records a fence (a CUDA event) after each flush and waits on the
oldest fence only: host work for one flush overlaps device work for
another, as in a server, and nothing synchronises the whole device. A
request's latency runs from its submit to the moment the harness sees its
flush's fence complete.

The system under test is anything with ``submit(x) -> ticket``,
``pending`` and ``flush() -> {ticket: y}``: the program's
``RequestBatcher``, or the control put in its place.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import random
import time
from typing import Callable, List, Optional, Tuple

import torch

clock = time.perf_counter


class Fence:
    """A point in the device's work: a CUDA event recorded on the current
    stream, or, on the CPU, a point already reached."""

    def __init__(self, device: torch.device):
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()


class Sampler:
    """A uniform sample of ``size`` answers out of all that came (reservoir
    sampling, algorithm R), drawn from the run's seed. Each sampled
    request's ``x`` and answer are copied into buffers allocated once, in
    the set-up, so that sampling allocates nothing in the window and holds
    no block of the program's allocator. An answer of another shape than
    ``(m,)`` is counted as ``malformed`` and not kept."""

    def __init__(self, size: int, seed: int, shape, device):
        m, n = shape
        self.size = size
        self._rng = random.Random(seed)
        self.seen = 0
        self.malformed = 0
        self._m = m
        self._xs = torch.empty((size, n), dtype=torch.float32, device=device)
        self._ys = torch.empty((size, m), dtype=torch.float32, device=device)
        self._filled = 0

    @property
    def items(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(self._xs[i], self._ys[i]) for i in range(self._filled)]

    def offer(self, x: torch.Tensor, y: torch.Tensor) -> None:
        if tuple(y.shape) != (self._m,):
            self.malformed += 1
            return
        i = self.seen
        self.seen = i + 1
        if self._filled < self.size:
            slot = self._filled
            self._filled += 1
        else:
            slot = self._rng.randrange(i + 1)
            if slot >= self.size:
                return
        self._xs[slot].copy_(x)
        self._ys[slot].copy_(y)


@dataclasses.dataclass
class LoopResult:
    attempted: int = 0          # requests submitted while the loop was open
    answered: int = 0           # answered while it was open
    missing: int = 0            # submitted, and no answer came at all
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    flush_ks: List[int] = dataclasses.field(default_factory=list)  # each
    window_s: float = 0.0       # first submit to the close
    drain_s: float = 0.0        # first submit to the last answer


def _noop(_name):
    return contextlib.nullcontext()


def closed_loop(system, draw: Callable[[], torch.Tensor], *, clients: int,
                device: torch.device, seconds: Optional[float] = None,
                max_flushes: Optional[int] = None,
                sampler: Optional[Sampler] = None,
                annotate: Callable = _noop) -> LoopResult:
    """Run ``clients`` closed-loop clients against ``system`` until
    ``seconds`` have passed or ``max_flushes`` flushes have been answered,
    whichever comes first; then stop submitting and wait for every flush in
    flight. Only answers seen before the close count as answered; every
    answer that comes is offered to ``sampler``. ``annotate(name)`` is a
    context manager named after each host phase (the profiler's
    ``record_function`` in a traced stretch)."""
    if seconds is None and max_flushes is None:
        raise ValueError("give seconds or max_flushes")
    res = LoopResult()
    fifo: collections.deque = collections.deque()   # tickets in queue order
    sent = {}                                       # ticket -> (t, x)
    inflight: collections.deque = collections.deque()

    def submit():
        with annotate("bench/draw"):
            x = draw()
        with annotate("bench/submit"):
            t = clock()
            rid = system.submit(x)
        sent[rid] = (t, x)
        fifo.append(rid)
        res.attempted += 1

    t0 = clock()
    end = None if seconds is None else t0 + seconds
    for _ in range(clients):
        submit()
    answered_flushes = 0
    closed_at = None
    while True:
        while system.pending:
            before = system.pending
            with annotate("bench/flush"):
                out = system.flush()
                fence = Fence(device)
            taken = before - system.pending
            if taken <= 0:
                raise RuntimeError("a flush took no queued request")
            tickets = [fifo.popleft() for _ in range(taken)]
            res.flush_ks.append(taken)
            inflight.append((fence, out, tickets))
        if not inflight:
            break
        fence, out, tickets = inflight.popleft()
        with annotate("bench/wait"):
            fence.wait()
        t = clock()
        in_window = closed_at is None and (end is None or t < end)
        if closed_at is None:
            answered_flushes += 1
            if end is not None and t >= end:
                closed_at = end
            elif max_flushes is not None and answered_flushes >= max_flushes:
                closed_at = t
        with annotate("bench/answer"):
            for rid in tickets:
                t_sub, x = sent.pop(rid)
                y = out.get(rid)
                if y is None:
                    res.missing += 1
                    continue
                if in_window:
                    res.answered += 1
                    res.latencies_s.append(t - t_sub)
                if sampler is not None:
                    sampler.offer(x, y)
            del out
        if closed_at is None:
            for _ in tickets:
                submit()
    res.missing += len(sent)            # queued and never flushed
    res.drain_s = clock() - t0
    res.window_s = (closed_at if closed_at is not None else clock()) - t0
    return res
