"""SELL-C-σ storage (sliced ELLPACK with σ-window row sorting).

Rows are grouped into slices of height C, each slice padded only to its
own longest row, and rows are sorted by length inside windows of σ rows so
that similar-length rows share a slice [Kreutzer et al.; Gao et al.,
arXiv:2404.06047 §4]. Row sorting is a permutation, recorded in
``row_perm`` and undone by one scatter at the end of the multiply.

Layout (width-major, slice-concatenated), identical to
``repro.spmm.sellcs``:

  ``data[w, l]`` / ``cols[w, l]`` — the ``j``-th nonzero of the row in lane
  ``l`` of slice ``slice_of[w]``, where ``j = w - slice_ptr[slice_of[w]]``.
  Padding entries carry ``data == 0`` and ``cols == 0`` (harmless FMA).

This slice keeps the JAX package's ``DEFAULT_C = 128`` and
``DEFAULT_SIGMA_SLICES`` so the served stream is exactly the one the
reference builds; a slice height chosen for Hopper is a measured later
change. One-triangle ``structure="symmetric"`` storage comes with the
transpose kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import COO

DEFAULT_C = 128
DEFAULT_SIGMA_SLICES = 16   # default σ = 16 slices' worth of rows

SYMMETRIC_SLICE = ("structure='symmetric' (one-triangle storage) is not "
                   "ported yet: it comes with the transpose kernel slice "
                   "(ROADMAP queue 2, kernel K3)")


@dataclasses.dataclass(eq=False)
class SellCS:
    """SELL-C-σ matrix on one device (see module docstring for layout)."""
    data: torch.Tensor          # f32[W, C] — padded values, width-major
    cols: torch.Tensor          # int32[W, C] — padded column indices
    slice_ptr: torch.Tensor     # int32[S+1] — width offset of each slice
    slice_of: torch.Tensor      # int32[W] — owning slice of each width-row
    row_perm: torch.Tensor      # int32[S*C] — permuted slot -> original row
                                #   (padding slots point at m)
    row_len: torch.Tensor       # int32[S*C] — true nnz of each slot
    diag: Optional[torch.Tensor]
    shape: Tuple[int, int]
    chunk: int                  # C — slice height
    sigma: int                  # σ — sorting window (rows)
    nnz: int                    # stored nonzeros before padding
    structure: str = "general"

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def num_slices(self) -> int:
        return int(self.slice_ptr.shape[0]) - 1

    @property
    def padded_nnz(self) -> int:
        return int(self.data.shape[0]) * self.chunk

    @property
    def fill_ratio(self) -> float:
        """nnz / padded entries — 1.0 means σ-sorting removed all padding."""
        p = self.padded_nnz
        return self.nnz / p if p else 0.0

    def storage_bytes(self) -> int:
        """Every array the format stores: padded values + padded column
        indices + slice pointers + per-width-row slice ids + the row
        permutation + per-slot true row lengths (indices at 4 bytes)."""
        W = int(self.data.shape[0])
        b = int(W * self.chunk * (self.data.element_size() + 4)
                + self.slice_ptr.shape[0] * 4
                + self.slice_of.shape[0] * 4
                + self.row_perm.shape[0] * 4
                + self.row_len.shape[0] * 4)
        if self.diag is not None:
            b += int(self.diag.shape[0] * self.diag.element_size())
        return b

    def to_coo(self) -> COO:
        """Exact round-trip (host side), including explicit zeros."""
        C = self.chunk
        data = self.data.cpu().numpy()
        cols = self.cols.cpu().numpy()
        slice_ptr = self.slice_ptr.cpu().numpy().astype(np.int64)
        slice_of = self.slice_of.cpu().numpy().astype(np.int64)
        row_perm = self.row_perm.cpu().numpy().astype(np.int64)
        row_len = self.row_len.cpu().numpy().astype(np.int64)
        W = data.shape[0]
        dev = self.device
        if W == 0 or self.nnz == 0:
            z = np.zeros(0, np.int32)
            v = np.zeros(0, data.dtype)
            return COO(torch.from_numpy(z).to(dev), torch.from_numpy(z).to(dev),
                       torch.from_numpy(v).to(dev), self.shape,
                       host=(z, z, v))
        j = np.arange(W, dtype=np.int64) - slice_ptr[slice_of]       # [W]
        slot = slice_of[:, None] * C + np.arange(C, dtype=np.int64)  # [W, C]
        valid = j[:, None] < row_len[slot]
        rows = row_perm[slot][valid].astype(np.int32)
        vals = data[valid]
        ccols = cols[valid].astype(np.int32)
        return COO(torch.from_numpy(rows).to(dev),
                   torch.from_numpy(ccols).to(dev),
                   torch.from_numpy(vals).to(dev), self.shape,
                   host=(rows, ccols, vals))


def coo_to_sellcs(coo: COO, *, c: int = DEFAULT_C,
                  sigma: Optional[int] = None,
                  structure: str = "general") -> SellCS:
    """Convert COO -> SELL-C-σ on the COO's device (host-side build).

    ``sigma`` is the row-sorting window in rows, rounded up to a multiple
    of ``c``; ``None`` uses ``DEFAULT_SIGMA_SLICES * c``."""
    m, n = coo.shape
    if c < 1:
        raise ValueError(f"slice height C must be >= 1, got {c}")
    if structure == "symmetric":
        raise NotImplementedError(SYMMETRIC_SLICE)
    if structure != "general":
        raise ValueError(f"structure must be 'general' or 'symmetric', "
                         f"got {structure!r}")
    if sigma is None:
        sigma = DEFAULT_SIGMA_SLICES * c
    sigma = max(-(-sigma // c) * c, c)

    r_h, c_h, v_h = coo.host_triplets()
    rows = np.asarray(r_h, np.int64)
    cols = np.asarray(c_h, np.int64)
    vals = np.asarray(v_h)

    row_len_orig = (np.bincount(rows, minlength=m).astype(np.int64)
                    if m else np.zeros(0, np.int64))
    # σ-window sort: rows ordered by (window, -length, row) — stable, so
    # equal-length rows keep their relative order (reproducible)
    ridx = np.arange(m, dtype=np.int64)
    window = ridx // sigma
    order = np.lexsort((ridx, -row_len_orig, window))   # perm pos -> row

    S = max(-(-m // c), 1)
    slots = S * c
    row_perm = np.full(slots, m, np.int64)
    row_perm[:m] = order
    row_len = np.zeros(slots, np.int64)
    row_len[:m] = row_len_orig[order]

    widths = row_len.reshape(S, c).max(axis=1)          # per-slice width
    slice_ptr = np.zeros(S + 1, np.int64)
    np.cumsum(widths, out=slice_ptr[1:])
    W = int(slice_ptr[-1])
    slice_of = np.repeat(np.arange(S, dtype=np.int64), widths)

    data = np.zeros((W, c), np.float32 if vals.size == 0 else vals.dtype)
    col_arr = np.zeros((W, c), np.int32)
    if rows.size:
        inv = np.empty(m, np.int64)
        inv[order] = np.arange(m)
        p = inv[rows]                                   # permuted position
        sort2 = np.lexsort((cols, p))
        p, cc, vv = p[sort2], cols[sort2], vals[sort2]
        row_start = np.zeros(slots + 1, np.int64)
        np.cumsum(row_len, out=row_start[1:])
        j = np.arange(p.size, dtype=np.int64) - row_start[p]
        wrow = slice_ptr[p // c] + j
        lane = p % c
        data[wrow, lane] = vv
        col_arr[wrow, lane] = cc

    dev = coo.device

    def t(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(dev)

    return SellCS(
        data=torch.from_numpy(data).to(dev),
        cols=torch.from_numpy(col_arr).to(dev),
        slice_ptr=t(slice_ptr), slice_of=t(slice_of), row_perm=t(row_perm),
        row_len=t(row_len), diag=None, shape=tuple(coo.shape), chunk=int(c),
        sigma=int(sigma), nnz=int(rows.size), structure=structure)
