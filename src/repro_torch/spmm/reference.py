"""Pure-torch SpMM oracles (``Y = A @ X``, ``X: [n, k]``).

The correctness baselines for every format's multi-RHS multiply, and the
``impl="ref"`` path of the dispatcher. They run on CPU and CUDA alike and
return ``promote_types(data, x)`` — the kernels return float32. SpMV is the
``k = 1`` column of each of these.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import COO, CSR
from .sellcs import SYMMETRIC_SLICE, SellCS

TRANSPOSE_SLICE = ("op='T' (A^T X) is not ported yet: it comes with the "
                   "transpose kernel slice (ROADMAP queue 2, kernel K3)")


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


def spmm_sellcs(sc: SellCS, x: torch.Tensor) -> torch.Tensor:
    """Slice-structured SpMM: one gather + FMA per width-row, then a single
    permutation scatter back to original row order (padding slots scatter
    to row m, dropped)."""
    if sc.structure != "general":
        raise NotImplementedError(SYMMETRIC_SLICE)
    x2, squeeze = _as_2d(x)
    m, _ = sc.shape
    k = x2.shape[1]
    dtype = torch.promote_types(sc.data.dtype, x2.dtype)
    if sc.nnz == 0 or sc.data.shape[0] == 0:
        y = torch.zeros((m, k), dtype=dtype, device=x2.device)
        return y[:, 0] if squeeze else y
    y_slots = sellcs_slots_ref(sc.data, sc.cols, sc.slice_of, x2,
                               num_slices=sc.num_slices, chunk=sc.chunk)
    y = torch.zeros((m + 1, k), dtype=dtype, device=x2.device)
    y = y.index_add_(0, sc.row_perm.long(), y_slots)[:m]
    return y[:, 0] if squeeze else y


def spmm_ref(mat, x: torch.Tensor, *, op: str = "N") -> torch.Tensor:
    """Oracle dispatch over the storage formats this slice carries."""
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    if op == "T":
        raise NotImplementedError(TRANSPOSE_SLICE)
    if isinstance(mat, SellCS):
        return spmm_sellcs(mat, x)
    if isinstance(mat, COO):
        return spmm_coo(mat, x)
    if isinstance(mat, CSR):
        return spmm_csr(mat, x)
    raise TypeError(f"no SpMM oracle for {type(mat).__name__}")
