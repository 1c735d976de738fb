"""The reduction of a profiled stretch to the numbers the per-layer
readers take: the device's busy time, the device time of the multiply,
and the breakdown (device operations, and the idle gaps by what the host
was doing).

It reads the profiler's raw events (``kineto_results.events()``), not
``key_averages()``, which takes tens of seconds at 10^5 events. The
stretch is the host range ``bench/stretch``; the multiply is every device
operation launched inside a ``bench/multiply`` range, found through the
launch's correlation with a host event.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

STRETCH = "bench/stretch"
MULTIPLY = "bench/multiply"
TOP = 10


@dataclasses.dataclass
class Ev:
    name: str
    start: int                  # ns, the trace's clock
    end: int
    corr: int
    linked: int
    thread: int


@dataclasses.dataclass
class TraceSummary:
    window_s: float             # the stretch's range on the trace's clock
    busy_s: float               # union of device operations in it
    multiply_device_s: float    # union of the operations launched in one
    multiply_ops: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _events(prof) -> Tuple[List[Ev], List[Ev]]:
    """(host events, device operations). The profiler mirrors each host
    range (``record_function``) on the device's timeline as an annotation
    spanning the operations launched in it; those are not operations and
    are dropped, or the gaps inside a range would read as busy."""
    host, device = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        ev = Ev(e.name(), start, start + int(e.duration_ns()),
                int(e.correlation_id()), int(e.linked_correlation_id()),
                int(e.start_thread_id()))
        if e.device_type() != cuda:
            host.append(ev)
        elif not _annotation(e):
            device.append(ev)
    ranges = {e.name for e in host if e.name.startswith("bench/")}
    device = [e for e in device if e.name not in ranges]
    return host, device


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu")


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Ranges:
    """Sorted, non-overlapping host ranges; ``holds(t)`` in O(log n)."""

    def __init__(self, evs: List[Ev]):
        spans = _merge([(e.start, e.end) for e in evs])
        self.starts = [a for a, _ in spans]
        self.ends = [b for _, b in spans]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def summarise(prof) -> Optional[TraceSummary]:
    """The stretch's numbers, or None where the trace holds no stretch or
    no device operation."""
    host, device = _events(prof)
    stretch = [e for e in host if e.name == STRETCH]
    if not stretch or not device:
        return None
    s0, s1 = stretch[0].start, stretch[0].end
    main = stretch[0].thread
    device = [e for e in device if e.end > s0 and e.start < s1]
    if not device:
        return None

    busy = _merge([(max(e.start, s0), min(e.end, s1)) for e in device])
    busy_ns = sum(b - a for a, b in busy)

    # the multiply: device operations whose launch lies in a multiply range
    ranges = _Ranges([e for e in host if e.name == MULTIPLY])
    ops = {e.corr: e for e in host if not _is_runtime(e.name) and e.corr}
    runtime = {e.corr: e for e in host if _is_runtime(e.name) and e.corr}
    mult = []
    for e in device:
        # linked to the host operation that launched it, or correlated
        # with the runtime call that did (a kernel launched from C)
        op = ops.get(e.linked) if e.linked else None
        rt = runtime.get(e.corr)
        if (op is not None and ranges.holds(op.start)) or (
                rt is not None and ranges.holds(rt.start)):
            mult.append((e.start, e.end))
    # a union, not a sum: a dependent launch (the carry step) starts
    # before the kernel it waits for has ended
    mult_ns = sum(b - a for a, b in _merge(mult))

    by_name: Dict[str, int] = collections.defaultdict(int)
    for e in device:
        by_name[e.name[:120]] += min(e.end, s1) - max(e.start, s0)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps, prev = [], s0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if s1 > prev:
        gaps.append((prev, s1))
    idle = _gaps_by_host(gaps, [e for e in host if e.thread == main])
    return TraceSummary(
        window_s=(s1 - s0) / 1e9, busy_s=busy_ns / 1e9,
        multiply_device_s=mult_ns / 1e9, multiply_ops=len(mult),
        device_ops=[(n, ns / 1e9) for n, ns in device_ops],
        idle_gaps=idle)


def _gaps_by_host(gaps, host: List[Ev]) -> List[Tuple[str, float]]:
    """Idle device time summed by the host range open at each gap's middle:
    the innermost ``bench/`` phase and the innermost operation in it."""
    evs = sorted((e for e in host if e.name != STRETCH),
                 key=lambda e: (e.start, -e.end))
    stack: List[Ev] = []
    i = 0
    acc: Dict[str, int] = collections.defaultdict(int)
    for g0, g1 in gaps:
        t = (g0 + g1) // 2
        while i < len(evs) and evs[i].start <= t:
            while stack and stack[-1].end <= evs[i].start:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        live = [e for e in stack if e.end > t]
        if not live:
            label = "between host ranges"
        else:
            inner = live[-1].name
            phase = next((e.name for e in reversed(live)
                          if e.name.startswith("bench/")), None)
            label = inner if phase in (None, inner) else f"{phase} > {inner}"
        acc[label[:120]] += g1 - g0
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:TOP]
    return [(n, ns / 1e9) for n, ns in top]
