"""Shared set-up of the benchmark's CPU tests: ``bench/`` and the port's
``src/`` on the path, two torch threads, tiny cells, and the fixture that
decides whether a card is there."""
import functools
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from benchlib.spec import Cell, load_cell, load_part  # noqa: E402

TINY = {
    "uniform": {"m": 3000, "n": 3000, "nnz": 57000},
    "road_grid": {"n": 2500, "width": 50, "nnz": 6026},
}
CONFIG_OF = {"uniform": "cage15-sellcs.json",
             "road_grid": "road_usa-parcrs.json"}
# the committed cells of each configuration, by clients
CELL_OF = {("uniform", 64): "hhh-sellcs.clients64",
           ("road_grid", 64): "road-parcrs.clients64",
           ("road_grid", 1): "road-parcrs.clients1"}
PortSystem = load_part(BENCH, "systems", "repro_torch_spmv").System


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def published_config(generator: str) -> dict:
    with open(BENCH / "configs" / CONFIG_OF[generator]) as f:
        return json.load(f)


def tiny_cell(generator: str, clients: int, *, samples: int = 16,
              metrics: bool = False) -> Cell:
    """A cell of the configuration's class, limit and batcher settings at a
    size the CPU runs in a second."""
    cfg = dict(published_config(generator), params=TINY[generator])
    traffic = {"loop": "closed", "clients": clients, "warmup_flushes": 2,
               "trace_flushes": 12, "check_samples": samples}
    e2e, per_layer = [], []
    if metrics:
        # the metrics of the committed cell of the class, as many clients
        like = load_cell(CELL_OF[generator, clients])
        e2e, per_layer = like.end_to_end, like.per_layer
    return Cell(f"tiny-{generator}.clients{clients}", 1, cfg, traffic, e2e,
                per_layer)


def run_tiny(cell: Cell, *, seed: int = 3_000_000_001, seconds: float = 0.3,
             trace: bool = False, system_factory=None, device="cpu"):
    from benchlib.cell import run_cell
    if system_factory is None:
        system_factory = functools.partial(
            PortSystem, impl="plain" if str(device) == "cpu" else "auto")
    return run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                    device=device, t_start=time.perf_counter(),
                    system_factory=system_factory)
