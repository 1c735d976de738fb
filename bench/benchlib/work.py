"""The needed work of a multiply and the least time the card could take
for it: the benchmark's own count, frozen here so that a change to the
program's roofline code cannot move the yardstick.

The needed work of ``Y = A X`` for ``k`` requests is the same whatever the
storage format: ``2 nnz k`` flops, and bytes of 8 a nonzero (a float32
value and an int32 column), 4 a row offset (``m + 1`` of them), X read
once (``4 n k``) and Y written once (``4 m k``). Padding columns that the
batcher adds are not requests and are not counted.

The least time is the larger of flops over the float32 peak and bytes
over the memory bandwidth, at the published rates of one NVIDIA H100 SXM
(data sheet, 700 W, dense, outside the tensor cores).
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_FLOPS_F32 = 67e12          # float32 FLOP/s, H100 SXM data sheet
PEAK_BYTES_S = 3.35e12          # HBM3 bytes/s, H100 SXM data sheet
PEAKS_SOURCE = "NVIDIA H100 SXM data sheet: 67 TFLOP/s f32, 3.35 TB/s"


def spmm_needed(nnz: int, m: int, n: int, k: int) -> Tuple[int, int]:
    """(flops, bytes) that ``Y = A X`` with ``k`` requests needs."""
    if k < 0 or nnz < 0 or m < 0 or n < 0:
        raise ValueError("sizes must be non-negative")
    flops = 2 * nnz * k
    nbytes = 8 * nnz + 4 * (m + 1) + 4 * n * k + 4 * m * k
    return flops, nbytes


def least_time_s(flops: float, nbytes: float) -> float:
    """The larger of the compute bound and the memory bound."""
    return max(flops / PEAK_FLOPS_F32, nbytes / PEAK_BYTES_S)


def flushes_least_time_s(nnz: int, m: int, n: int,
                         ks: Iterable[int]) -> float:
    """Least time of a run of flushes, one multiply a flush of ``k`` real
    requests each."""
    return sum(least_time_s(*spmm_needed(nnz, m, n, k)) for k in ks if k)
