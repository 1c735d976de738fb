"""The frozen needed-work count and the least-time arithmetic."""
import pytest

from benchlib.work import (PEAK_BYTES_S, PEAK_FLOPS_F32,
                           flushes_least_time_s, least_time_s, spmm_needed)

CAGE = (99199551, 5154859, 5154859)      # nnz, m, n
ROAD = (57708624, 23947347, 23947347)


def test_needed_work_counts():
    flops, nbytes = spmm_needed(10, 4, 5, 3)
    assert flops == 2 * 10 * 3
    assert nbytes == 8 * 10 + 4 * 5 + 4 * 5 * 3 + 4 * 4 * 3


@pytest.mark.parametrize("sizes,k,ms", [
    (CAGE, 32, 0.637), (ROAD, 32, 1.996), (ROAD, 1, 0.224)])
def test_least_time_of_the_cells(sizes, k, ms):
    """The bounds the issue and PERF.md quote: memory-bound at every k."""
    flops, nbytes = spmm_needed(*sizes, k)
    assert nbytes / PEAK_BYTES_S > flops / PEAK_FLOPS_F32
    assert least_time_s(flops, nbytes) * 1e3 == pytest.approx(ms, abs=5e-4)


def test_least_time_takes_the_larger_bound():
    assert least_time_s(67e12, 0) == pytest.approx(1.0)
    assert least_time_s(0, 3.35e12) == pytest.approx(1.0)
    assert least_time_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_flushes_sum_and_skip_empty():
    one = least_time_s(*spmm_needed(*CAGE, 32))
    assert flushes_least_time_s(*CAGE, [32, 32, 0]) == pytest.approx(2 * one)
    assert flushes_least_time_s(*CAGE, []) == 0


def test_negative_sizes_refused():
    with pytest.raises(ValueError):
        spmm_needed(-1, 1, 1, 1)
