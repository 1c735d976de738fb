"""Merge-path load balancing (paper §3.3, Merrill & Garland 2016).

The merge path runs over two "lists": A = row_ptr[1:] (row end offsets,
length m) and B = the natural numbers 0..nnz-1 (nonzero indices). Total path
length is m + nnz; cutting it into P equal diagonals gives every worker the
same number of (multiply-add | row-output) operations — perfect static load
balance for arbitrary row distributions, including the mawi-like single
dense row that breaks row-distributed schemes (paper Table 6.3).

At diagonal d the split (i, j), i + j = d, is the smallest i such that
A[i] + i >= d. This runs once per matrix on the host, at plan time, never
per multiply. :func:`balanced_row_bands` is the row-band alternative that
the BCOH family's static schedule uses.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def merge_path_partition_np(row_ptr: np.ndarray,
                            num_parts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cut the merge path of a CSR structure into ``num_parts`` equal
    spans; returns int32 (row_starts, nnz_starts), each of length P+1."""
    row_ptr = np.asarray(row_ptr, np.int64)
    m = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1])
    total = m + nnz
    step = -(-total // num_parts)
    diag = np.minimum(np.arange(num_parts + 1, dtype=np.int64) * step, total)
    keys = row_ptr[1:] + np.arange(m, dtype=np.int64)
    i = np.searchsorted(keys, diag, side="left")
    j = diag - i
    return i.astype(np.int32), j.astype(np.int32)


def balanced_row_bands(row_ptr: np.ndarray, num_bands: int) -> np.ndarray:
    """BCOH-style static distribution (paper §3.2): split *rows* so every
    band holds ~nnz/P nonzeros. Returns int32[num_bands+1] row boundaries.

    Unlike merge-path this never splits a row — a single dense row defeats
    it (paper Table 6.3) — but it needs no carry-out fixup and each band
    writes its own rows of y."""
    row_ptr = np.asarray(row_ptr, np.int64)
    nnz = int(row_ptr[-1])
    m = row_ptr.shape[0] - 1
    targets = (np.arange(num_bands + 1, dtype=np.int64) * nnz) // num_bands
    bounds = np.searchsorted(row_ptr, targets, side="left")
    bounds[0], bounds[-1] = 0, m
    return np.maximum.accumulate(bounds).astype(np.int32)
