"""One run of one cell: set-up, the measured window (``trace=False``) or
the two traced stretches (``trace=True``), then the check of the sampled
answers against the reference.

The traced run has two stretches. The first runs under ``torch.profiler``
with no registry of the program's ``obs`` installed (its spans synchronise
the device when one is), and gives the device's busy time, the multiply's
device time and the breakdown. The second runs with a registry installed
and gives the batcher's pad and multiply spans.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import matrices
from .loop import LoopResult, Sampler
from .reference import Reference, normalised_error
from .spec import Cell, load_part
from .trace import STRETCH, TraceSummary, summarise


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: str
    config: dict
    traffic: dict
    shape: Tuple[int, int]
    nnz: int
    setup_s: float
    convert_s: float
    window: Optional[LoopResult] = None       # trace=False
    stretch: Optional[LoopResult] = None      # trace=True, profiled
    trace: Optional[TraceSummary] = None
    spans: Dict[str, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)                 # trace=True, registry


@dataclasses.dataclass
class Outcome:
    run: Run
    attempted: int
    missing: int
    errors: List[float]         # one normalised error a sampled answer
    limit: float
    memory_peak_bytes: int

    @property
    def wrong(self) -> int:
        return sum(1 for e in self.errors if not e <= self.limit)

    @property
    def max_error(self) -> float:
        return max(self.errors) if self.errors else float("inf")

    @property
    def correct(self) -> bool:
        return bool(self.errors) and self.missing == 0 and self.wrong == 0

    def checks(self) -> Dict[str, Dict[str, float]]:
        """Each number compared, beside its limit."""
        return {
            "max_norm_err": {"value": self.max_error, "limit": self.limit},
            "missing_answers": {"value": self.missing, "limit": 0},
            "samples_at_least": {"value": len(self.errors), "limit": 1},
        }


def _record(name):
    return torch.profiler.record_function(name)


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float,
             system_factory: Optional[Callable] = None) -> Outcome:
    """One run. ``system_factory(config, triplets, device)`` builds the
    system under test (default: the ``System`` of ``systems/<system>.py``,
    the configuration's ``system``); the mix's ``loop`` names the load
    (``loops/<loop>.py``); ``t_start`` is the host clock at the process's
    start, from which ``setup_s`` runs to the first timed submit."""
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    if system_factory is None:
        system_factory = load_part(cell.bench_dir, "systems",
                                   cfg["system"]).System
    loop = load_part(cell.bench_dir, "loops", traffic["loop"]).run
    triplets = matrices.generate(cfg, seed, device, cell.bench_dir)
    shape, nnz = tuple(triplets[3]), int(triplets[0].size)
    system = system_factory(cfg, triplets, device)

    gx = torch.Generator(device=device)
    gx.manual_seed(matrices.request_seed(seed))

    def draw():
        return torch.randn(shape[1], generator=gx, device=device)

    sampler = Sampler(int(traffic["check_samples"]), seed, shape, device)
    # warm-up: the cell's own batch shapes, through the same loop
    loop(system.batcher(), draw, traffic, device=device,
         max_flushes=int(traffic["warmup_flushes"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell.name, cfg, traffic, shape, nnz,
              setup_s=time.perf_counter() - t_start,
              convert_s=system.convert_s)
    if not trace:
        run.window = loop(system.batcher(), draw, traffic, device=device,
                          seconds=seconds, sampler=sampler)
        attempted, missing = run.window.attempted, run.window.missing
    else:
        flushes = int(traffic["trace_flushes"])
        run.stretch, run.trace = _profiled(system, loop, draw, traffic,
                                           device, seconds, flushes, sampler)
        with system.spans() as spans:
            second = loop(system.batcher(), draw, traffic, device=device,
                          seconds=seconds, max_flushes=flushes,
                          sampler=sampler)
        run.spans = spans
        attempted = run.stretch.attempted + second.attempted
        missing = run.stretch.missing + second.missing
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    system.close()
    del system
    ref = Reference(triplets, device)
    errors = [normalised_error(ref, x, y) for x, y in sampler.items]
    errors += [float("inf")] * sampler.malformed
    return Outcome(run, attempted, missing, errors,
                   float(cfg["check"]["max_norm_err"]), int(peak))


def _profiled(system, loop, draw, traffic, device, seconds, flushes,
              sampler):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    batcher = system.batcher(annotate=True)
    with profile(activities=acts) as prof:
        with _record(STRETCH):
            res = loop(batcher, draw, traffic, device=device,
                       seconds=seconds, max_flushes=flushes,
                       sampler=sampler, annotate=_record)
    return res, summarise(prof)


def read_metrics(metrics, run: Run) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "unit"}}`` of every reader that found something
    to read."""
    out = {}
    for m in metrics:
        v = m.read(run)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


__all__ = ["Run", "Outcome", "run_cell", "read_metrics"]
