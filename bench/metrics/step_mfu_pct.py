"""step_mfu_pct: the least time of all the profiled stretch's answered
requests' needed work (benchlib.work) over the stretch's wall time: the
whole serving step's share of the chip's peak. Layer: whole step; moves
requests_per_s."""
from benchlib.work import flushes_least_time_s


def read(run):
    t, s = run.trace, run.stretch
    if t is None or s is None or t.window_s <= 0:
        return None
    m, n = run.shape
    least = flushes_least_time_s(run.nnz, m, n, s.flush_ks)
    return 100.0 * least / t.window_s
