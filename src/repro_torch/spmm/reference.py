"""Pure-torch SpMM oracles (``Y = A @ X``, ``X: [n, k]``, and the
transpose ``Y = A^T X``, ``X: [m, k]``).

The correctness baselines for every format's multi-RHS multiply, and the
``impl="ref"`` path of the dispatcher. They run on CPU and CUDA alike and
return ``promote_types(data, x)`` — the kernels return float32. SpMV is the
``k = 1`` column of each of these.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import COO, CSR, BlockedSparse
from repro_torch.kernels.ref import bsr_spmm_ref
from repro_torch.kernels.tiling import TiledSparse
from .sellcs import SellCS


def _as_2d(x: torch.Tensor):
    """Return (X_2d, was_1d): SpMV inputs ride along as k = 1."""
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim != 2:
        raise ValueError(f"X must be [n] or [n, k], got shape {tuple(x.shape)}")
    return x, False


def _scatter_rows(num_rows: int, rows: torch.Tensor, contrib: torch.Tensor,
                  dtype) -> torch.Tensor:
    y = torch.zeros((num_rows, contrib.shape[1]), dtype=dtype,
                    device=contrib.device)
    return y.index_add_(0, rows.long(), contrib.to(dtype))


def spmm_coo(coo: COO, x: torch.Tensor) -> torch.Tensor:
    x2, squeeze = _as_2d(x)
    m, _ = coo.shape
    dtype = torch.promote_types(coo.data.dtype, x2.dtype)
    if coo.nnz == 0:
        y = torch.zeros((m, x2.shape[1]), dtype=dtype, device=x2.device)
    else:
        contrib = coo.data.to(dtype)[:, None] * x2.to(dtype)[coo.cols.long()]
        y = _scatter_rows(m, coo.rows, contrib, dtype)
    return y[:, 0] if squeeze else y


def spmm_csr(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    x2, squeeze = _as_2d(x)
    m, _ = csr.shape
    dtype = torch.promote_types(csr.data.dtype, x2.dtype)
    if csr.nnz == 0:
        y = torch.zeros((m, x2.shape[1]), dtype=dtype, device=x2.device)
    else:
        contrib = (csr.data.to(dtype)[:, None]
                   * x2.to(dtype)[csr.col_ind.long()])
        y = _scatter_rows(m, csr.row_of_nnz(), contrib, dtype)
    return y[:, 0] if squeeze else y


def spmm_blocked(bs: BlockedSparse, x: torch.Tensor) -> torch.Tensor:
    """Blocked-format SpMM: decode (block, local) -> global coordinates,
    gather/FMA, scatter-add, in storage order."""
    x2, squeeze = _as_2d(x)
    m, _ = bs.shape
    dtype = torch.promote_types(bs.data.dtype, x2.dtype)
    if bs.nnz == 0:
        y = torch.zeros((m, x2.shape[1]), dtype=dtype, device=x2.device)
    else:
        rows, cols = bs.global_rows_cols()
        contrib = bs.data.to(dtype)[:, None] * x2.to(dtype)[cols]
        y = _scatter_rows(m, rows, contrib, dtype)
    return y[:, 0] if squeeze else y


def sellcs_slots_ref(data: torch.Tensor, cols: torch.Tensor,
                     slice_of: torch.Tensor, x2: torch.Tensor, *,
                     num_slices: int, chunk: int) -> torch.Tensor:
    """Raw-array slot accumulation [num_slices*chunk, k] — the oracle of
    ``repro_torch.spmm.kernels.sellcs_slots``. No row permutation is
    applied."""
    dtype = torch.promote_types(data.dtype, x2.dtype)
    xs = x2.to(dtype)[cols.long()]                       # [W, C, k]
    contrib = data.to(dtype)[:, :, None] * xs            # [W, C, k]
    slot = (slice_of.long()[:, None] * chunk
            + torch.arange(chunk, device=data.device)[None])     # [W, C]
    y = torch.zeros((num_slices * chunk, x2.shape[1]), dtype=dtype,
                    device=data.device)
    return y.index_add_(0, slot.reshape(-1),
                        contrib.reshape(-1, x2.shape[1]))


def sellcs_slot_x(row_perm: torch.Tensor, x2: torch.Tensor,
                  m: int) -> torch.Tensor:
    """Permute X into slot space for the transpose pass: ``x_slots[s] =
    X[row_perm[s]]``, with padding slots (``row_perm == m``) reading a zero
    row. After this gather the transpose pass reads one contiguous C-block
    of X per width-row."""
    x_pad = torch.cat([x2, x2.new_zeros((1, x2.shape[1]))], dim=0)
    return x_pad.index_select(0, row_perm.long())


def sellcs_slots_t_ref(data: torch.Tensor, cols: torch.Tensor,
                       slice_of: torch.Tensor, x_slots: torch.Tensor, *,
                       n_out: int, chunk: int) -> torch.Tensor:
    """Transpose slot pass [n_out, k] — the oracle of
    ``repro_torch.spmm.kernels.sellcs_slots_t``: each width-row reads its
    C-block of the slot-permuted X and scatter-adds into its columns. The
    output is in natural column order (the σ-permutation was consumed by
    :func:`sellcs_slot_x`). Padding entries (data == 0, cols == 0) add
    zero into column 0."""
    dtype = torch.promote_types(data.dtype, x_slots.dtype)
    k = x_slots.shape[1]
    slot = (slice_of.long()[:, None] * chunk
            + torch.arange(chunk, device=data.device)[None])     # [W, C]
    contrib = data.to(dtype)[:, :, None] * x_slots.to(dtype)[slot]
    y = torch.zeros((n_out, k), dtype=dtype, device=data.device)
    return y.index_add_(0, cols.reshape(-1).long(), contrib.reshape(-1, k))


def spmm_sellcs(sc: SellCS, x: torch.Tensor) -> torch.Tensor:
    """Slice-structured SpMM: one gather + FMA per width-row, then a single
    permutation scatter back to original row order (padding slots scatter
    to row m, dropped). Symmetric one-triangle storage combines the normal
    and transpose passes over the stored triangle:
    ``A X = N(X) + T(X) - diag * X``."""
    x2, squeeze = _as_2d(x)
    m, n = sc.shape
    k = x2.shape[1]
    dtype = torch.promote_types(sc.data.dtype, x2.dtype)
    if sc.nnz == 0 or sc.data.shape[0] == 0:
        y = torch.zeros((m, k), dtype=dtype, device=x2.device)
        return y[:, 0] if squeeze else y
    y_slots = sellcs_slots_ref(sc.data, sc.cols, sc.slice_of, x2,
                               num_slices=sc.num_slices, chunk=sc.chunk)
    y = torch.zeros((m + 1, k), dtype=dtype, device=x2.device)
    y = y.index_add_(0, sc.row_perm.long(), y_slots)[:m]
    if sc.structure == "symmetric":
        xs = sellcs_slot_x(sc.row_perm, x2, m)
        y = (y + sellcs_slots_t_ref(sc.data, sc.cols, sc.slice_of, xs,
                                    n_out=n, chunk=sc.chunk)
             - sc.diag.to(dtype)[:, None] * x2.to(dtype))
    return y[:, 0] if squeeze else y


def spmm_sellcs_t(sc: SellCS, x: torch.Tensor) -> torch.Tensor:
    """``Y = A^T X`` over the same stored stream (``X: [m, k]``,
    ``Y: [n, k]``). For symmetric storage ``A^T == A``, so this is exactly
    the symmetric forward multiply."""
    if sc.structure == "symmetric":
        return spmm_sellcs(sc, x)
    x2, squeeze = _as_2d(x)
    m, n = sc.shape
    k = x2.shape[1]
    dtype = torch.promote_types(sc.data.dtype, x2.dtype)
    if sc.nnz == 0 or sc.data.shape[0] == 0:
        y = torch.zeros((n, k), dtype=dtype, device=x2.device)
        return y[:, 0] if squeeze else y
    xs = sellcs_slot_x(sc.row_perm, x2, m)
    y = sellcs_slots_t_ref(sc.data, sc.cols, sc.slice_of, xs,
                           n_out=n, chunk=sc.chunk)
    return y[:, 0] if squeeze else y


def spmm_coo_t(coo: COO, x: torch.Tensor) -> torch.Tensor:
    """``Y = A^T X`` oracle on triplets (the transpose is a relabeling)."""
    m, n = coo.shape
    return spmm_coo(COO(coo.cols, coo.rows, coo.data, (n, m)), x)


def spmm_ref(mat, x: torch.Tensor, *, op: str = "N") -> torch.Tensor:
    """Oracle dispatch over every supported storage format. ``op='T'``
    computes ``A^T X`` (supported for SellCS and COO)."""
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    if op == "T":
        if isinstance(mat, SellCS):
            return spmm_sellcs_t(mat, x)
        if isinstance(mat, COO):
            return spmm_coo_t(mat, x)
        raise TypeError(
            f"no transpose SpMM oracle for {type(mat).__name__}")
    if isinstance(mat, TiledSparse):
        x2, squeeze = _as_2d(x)
        y = bsr_spmm_ref(mat, x2)
        return y[:, 0] if squeeze else y
    if isinstance(mat, SellCS):
        return spmm_sellcs(mat, x)
    if isinstance(mat, COO):
        return spmm_coo(mat, x)
    if isinstance(mat, CSR):
        return spmm_csr(mat, x)
    if isinstance(mat, BlockedSparse):
        return spmm_blocked(mat, x)
    raise TypeError(f"no SpMM oracle for {type(mat).__name__}")
