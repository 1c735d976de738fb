"""A traced run of a tiny cell on the card, through the port's kernels:
the profiler's device events are read, the multiply's operations are
found through their launches, and no share passes 100 %. Runs on the
card with ``python -m pytest -q -m cuda bench/tests``."""
import pytest

from benchlib.cell import read_metrics
from conftest import run_tiny, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["uniform", "road_grid"])
def test_traced_tiny_cell_on_the_card(cuda_device, gen):
    cell = tiny_cell(gen, 64, metrics=True)
    out = run_tiny(cell, trace=True, seconds=2.0, device=cuda_device)
    assert out.correct, out.checks()
    t = out.run.trace
    assert t is not None and t.multiply_ops > 0 and t.busy_s > 0
    got = read_metrics(cell.per_layer, out.run)
    assert set(got) == {m.name for m in cell.per_layer}
    for name in ("spmm_roofline", "step_mfu_pct", "device_idle_pct"):
        assert 0 < got[name]["value"] <= 100, (name, got[name])
    assert out.memory_peak_bytes > 0
