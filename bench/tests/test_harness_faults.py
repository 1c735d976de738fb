"""Drives a whole run on the CPU, past the harness's look for a card,
with the timed path broken under the batcher, and sees ``correct`` come
out false for each fault a serving cell can have: a multiply that returns
its last state unchanged, half of the batch left out, an answer altered
where it is produced, and answers that never come."""
import pytest

from benchlib.cell import read_metrics
from conftest import PortSystem, run_tiny, tiny_cell


class Broken(PortSystem):
    """The port with one fault planted in its operator's multiply."""

    fault = None

    def __init__(self, config, triplets, device):
        super().__init__(config, triplets, device, impl="plain")
        op, fault, last = self.op, self.fault, {}
        real = op.matmul

        def matmul(X):
            Y = real(X)
            if fault == "stale":
                prev = last.get("Y")
                last["Y"] = Y
                return Y if prev is None or prev.shape != Y.shape else prev
            if fault == "half_batch":
                Y = Y.clone()
                Y[:, Y.shape[1] // 2:] = 0
                return Y
            if fault == "altered":
                Y = Y.clone()
                Y[0] += 1.0
                return Y
            return Y
        op.matmul = matmul

    def batcher(self, annotate=False):
        b = super().batcher(annotate)
        if self.fault == "dropped":
            flush = b.flush

            def dropping():
                out = flush()
                return dict(list(out.items())[:max(1, len(out) // 2)])
            b.flush = dropping
        return b


def _with(fault):
    return type(f"Broken_{fault}", (Broken,), {"fault": fault})


@pytest.mark.parametrize("gen,clients", [("uniform", 64), ("road_grid", 64),
                                         ("road_grid", 1)])
@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered",
                                   "dropped"])
def test_fault_makes_the_run_incorrect(gen, clients, fault):
    if clients == 1 and fault in ("half_batch", "dropped"):
        # a flush of one request has no half; a whole dropped answer is
        # the "dropped" fault of the 64-client cells
        fault = "altered" if fault == "half_batch" else "stale"
    cell = tiny_cell(gen, clients)
    out = run_tiny(cell, system_factory=_with(fault))
    assert not out.correct, (fault, out.checks())


@pytest.mark.parametrize("gen,clients", [("uniform", 64), ("road_grid", 1)])
def test_sound_run_is_correct(gen, clients):
    out = run_tiny(tiny_cell(gen, clients), system_factory=_with(None))
    assert out.correct, out.checks()
    assert out.attempted > 0 and out.missing == 0


def test_traced_run_checks_both_stretches():
    cell = tiny_cell("uniform", 64, metrics=True)
    out = run_tiny(cell, trace=True, system_factory=_with("altered"))
    assert not out.correct
    ok = run_tiny(cell, trace=True)
    assert ok.correct
    assert set(ok.run.spans) == {"batcher/pad", "batcher/multiply"}
    # both stretches' requests are attempted and checked
    assert ok.attempted > sum(ok.run.stretch.flush_ks)
    got = read_metrics(cell.per_layer, ok.run)
    # the CPU has no device trace: those readers read nothing
    assert set(got) == {"convert_s", "pad_ms", "multiply_ms"}
    single = tiny_cell("road_grid", 1, metrics=True)
    one = run_tiny(single, trace=True)
    assert set(read_metrics(single.per_layer, one.run)) == {
        "convert_s", "pad_ms", "multiply_ms"}
