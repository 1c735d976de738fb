"""spmm_roofline: the least time of the multiplies' needed work (the
real requests of each flush of the profiled stretch; benchlib.work) over
the device time (the union of their intervals) of every operation
launched inside the benchmark's ``bench/multiply`` ranges. Layer:
kernels; moves requests_per_s."""
from benchlib.work import flushes_least_time_s


def read(run):
    t, s = run.trace, run.stretch
    if t is None or s is None or t.multiply_device_s <= 0:
        return None
    m, n = run.shape
    least = flushes_least_time_s(run.nnz, m, n, s.flush_ks)
    return 100.0 * least / t.multiply_device_s
