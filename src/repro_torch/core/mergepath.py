"""Merge-path load balancing (paper §3.3, Merrill & Garland 2016).

The merge path runs over two "lists": A = row_ptr[1:] (row end offsets,
length m) and B = the natural numbers 0..nnz-1 (nonzero indices). Total path
length is m + nnz; cutting it into P equal diagonals gives every worker the
same number of (multiply-add | row-output) operations — perfect static load
balance for arbitrary row distributions, including the mawi-like single
dense row that breaks row-distributed schemes (paper Table 6.3).

At diagonal d the split (i, j), i + j = d, is the smallest i such that
A[i] + i >= d. The kernels' plans cut it once per matrix on the host
(:func:`merge_path_partition_np`), never per multiply;
:func:`merge_path_partition` is the same cut on the row pointer's device.
:func:`balanced_row_bands` is the row-band alternative that the BCOH
family's static schedule uses, and :func:`span_block_aligned` cuts a
blocked format's blocks into equal-nonzero spans.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class MergePartition(NamedTuple):
    """Start coordinates per worker (length P+1; worker p owns
    [starts[p], starts[p+1]) on both axes)."""
    row_starts: torch.Tensor    # int32[P+1] — first row each worker touches
    nnz_starts: torch.Tensor    # int32[P+1] — first nonzero it consumes
    diagonals: torch.Tensor     # int32[P+1] — the cut diagonals


def merge_path_partition(row_ptr: torch.Tensor,
                         num_parts: int) -> MergePartition:
    """Cut the merge path of a CSR structure into ``num_parts`` equal
    spans on ``row_ptr``'s device: the same int32 cuts as
    ``repro.core.mergepath.merge_path_partition``."""
    row_ptr = torch.as_tensor(row_ptr).to(torch.int32)
    dev = row_ptr.device
    m = row_ptr.shape[0] - 1
    total = m + row_ptr[-1]
    p = torch.arange(num_parts + 1, dtype=torch.int32, device=dev)
    # equal diagonals, the last one clipped to the path end
    step = torch.div(total + num_parts - 1, num_parts,
                     rounding_mode="floor")
    diag = torch.minimum(p * step, total).to(torch.int32)
    keys = row_ptr[1:] + torch.arange(m, dtype=torch.int32, device=dev)
    i = torch.searchsorted(keys, diag, side="left").to(torch.int32)
    return MergePartition(row_starts=i, nnz_starts=diag - i, diagonals=diag)


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


def span_block_aligned(block_ptr: np.ndarray, num_parts: int) -> np.ndarray:
    """Equal-nonzero spans over *blocks* (a block is never split): worker
    p takes blocks [spans[p], spans[p+1]). Over-decomposing into
    ``num_parts`` much larger than the worker count bounds each span's
    excess by its largest block, CSB's task-split rule made static."""
    block_ptr = np.asarray(block_ptr, np.int64)
    nb = block_ptr.shape[0] - 1
    nnz = int(block_ptr[-1])
    targets = (np.arange(num_parts + 1, dtype=np.int64) * nnz) // num_parts
    spans = np.searchsorted(block_ptr, targets, side="left")
    spans[0], spans[-1] = 0, nb
    return np.maximum.accumulate(spans).astype(np.int32)
