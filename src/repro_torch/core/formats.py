"""Sparse storage formats as dataclasses of tensors (paper §2, §3, §4).

Flat formats
------------
``COO``    triplet format (rows, cols, data)                          [§2]
``CSR``    compressed row storage (row_ptr, col_ind, data)            [§2]
``ICRS``   incremental CRS (col_inc with overflow row signaling)      [§2]
``BICRS``  bidirectional ICRS (negative increments allowed)           [§2]

Blocked formats
---------------
``BlockedSparse`` is one parameterized container for the paper's CSB and
BCOH families and all six hybrids: the canonical arrays (``block_rows``,
``block_cols``, ``block_ptr``, ``packed``, ``data``) plus each variant's own
block-level storage, kept so its storage cost is counted faithfully.

Each object lives on one device (its tensors' device). Conversions run on
the host, so each object may also keep the numpy arrays it was built from
(``host``): later host-side planning (the merge plan, the SELL-C-σ sort)
reads those instead of copying the tensors back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def host_arrays(t: torch.Tensor) -> np.ndarray:
    """numpy view of a tensor (a device-to-host copy off the CPU)."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass(eq=False)
class COO:
    rows: torch.Tensor          # int32[nnz]
    cols: torch.Tensor          # int32[nnz]
    data: torch.Tensor          # float[nnz]
    shape: Tuple[int, int]
    host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def host_triplets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, data) as numpy, from the kept host copy if any."""
        if self.host is not None:
            return self.host
        return (host_arrays(self.rows), host_arrays(self.cols),
                host_arrays(self.data))

    def storage_bytes(self) -> int:
        return self.nnz * (4 + 4 + self.data.element_size())

    def todense(self) -> torch.Tensor:
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.data.dtype, device=self.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.data, accumulate=True)


@dataclasses.dataclass(eq=False)
class CSR:
    row_ptr: torch.Tensor       # int32[m+1]
    col_ind: torch.Tensor       # int32[nnz]
    data: torch.Tensor          # float[nnz]
    shape: Tuple[int, int]
    host: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = \
        dataclasses.field(default=None, repr=False)
    # merge plans built from ``host`` once per span count and reused by
    # every multiply (kernels.merge_spmv.cached_merge_plan)
    plans: Dict[int, object] = dataclasses.field(default_factory=dict,
                                                 repr=False)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def host_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ptr, col_ind, data) as numpy, from the kept host copy if
        any."""
        if self.host is not None:
            return self.host
        return (host_arrays(self.row_ptr), host_arrays(self.col_ind),
                host_arrays(self.data))

    def storage_bytes(self) -> int:
        return (self.row_ptr.shape[0] + self.col_ind.shape[0]) * 4 \
            + self.nnz * self.data.element_size()

    def row_of_nnz(self) -> torch.Tensor:
        """int32[nnz] row index of each stored element (decompression)."""
        k = torch.arange(self.nnz, dtype=torch.int32, device=self.device)
        return (torch.searchsorted(self.row_ptr, k, right=True) - 1
                ).to(torch.int32)


@dataclasses.dataclass(eq=False)
class ICRS:
    """Incremental CRS [Koster 2002]. ``col_start`` is the column of the
    first nonzero; ``col_inc[k]`` is the (possibly overflowed) increment
    applied *after* consuming nonzero k. ``row_jump[0]`` is the starting
    row; later entries are row increments consumed at each overflow."""
    col_start: int
    col_inc: torch.Tensor       # int32[nnz] — increment applied after nnz k
    row_jump: torch.Tensor      # int32[njumps] — [start_row, jump1, ...]
    data: torch.Tensor          # float[nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def storage_bytes(self, index_bytes: int = 4) -> int:
        return (1 + self.col_inc.shape[0] + self.row_jump.shape[0]) \
            * index_bytes + self.nnz * self.data.element_size()

    def to_coo(self) -> COO:
        return _incremental_decode(self)


class BICRS(ICRS):
    """Bidirectional ICRS [Yzelman & Bisseling 2012]: the ICRS encoding with
    signed increments, so the nonzeros may come in any order (Hilbert,
    Morton, ...)."""


def _incremental_decode(mat: ICRS) -> COO:
    """Algorithm 2.2's decoder: the (row, col) of every nonzero from the
    increment encoding, one overflow per row change (the encoder adds n
    exactly once per transition). The walk is sequential, so it runs on
    the host; the COO lands on the matrix's device."""
    n = mat.shape[1]
    inc = host_arrays(mat.col_inc).tolist()
    jumps = host_arrays(mat.row_jump).tolist()
    rows = np.empty(len(inc), np.int32)
    cols = np.empty(len(inc), np.int32)
    if inc:
        j, i, r, last = int(mat.col_start), jumps[0], 0, len(jumps) - 1
        for k, d in enumerate(inc):
            rows[k], cols[k] = i, j
            j += d
            if j >= n:
                j -= n
                r += 1
                i += jumps[min(r, last)]
    dev = mat.device
    return COO(torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
               mat.data, mat.shape)


# block-level storage schemes (paper §3.1, §3.2, §4.2, §4.3)
BLOCK_STORAGE_DENSE_PTR = "dense_ptr"   # CSB / CSBH / BCOHCHP
BLOCK_STORAGE_BICRS = "bicrs"           # BCOH / BCOHC / BCOHCH
BLOCK_STORAGE_CSR = "csr"               # MergeB / MergeBH

IN_BLOCK_PACKED_COO = "packed_coo"      # 16+16 packed indices (CSB + hybrids)
IN_BLOCK_ICRS = "icrs"                  # compressed ICRS (original BCOH)


@dataclasses.dataclass(eq=False)
class BlockedSparse:
    """Unified blocked sparse format.

    Canonical arrays (always present):
      block_rows/block_cols int32[nb] — block grid coordinates of the stored
        blocks, in *storage order*;
      block_ptr int32[nb+1] — nnz offsets per block (prefix sum);
      packed uint32[nnz] — (local_row << 16) | local_col per nonzero;
      data float[nnz].

    Variant-specific storage (zero-length where the variant has none):
      dense_ptr: grid_ptr int32[Mb*Nb+1] in the chosen block order;
      bicrs: blk_col_inc / blk_row_jump int32 block-level increments;
      csr: blk_row_ptr int32[Mb+1] (block_cols acts as col_ind).
    """
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    block_ptr: torch.Tensor
    packed: torch.Tensor
    data: torch.Tensor
    grid_ptr: torch.Tensor
    blk_col_inc: torch.Tensor
    blk_row_jump: torch.Tensor
    blk_row_ptr: torch.Tensor
    shape: Tuple[int, int]
    beta: int
    grid: Tuple[int, int]                # (Mb, Nb)
    block_storage: str
    block_order: str                     # "row" | "hilbert" | "morton"
    in_block_format: str
    in_block_order: str
    # start block-row of each band of the BCOH static row distribution
    # (length P+1); it parameterizes scheduling, not values
    row_bands: Tuple[int, ...] = ()

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.block_rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def local_rows_cols(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """int32 (local_row, local_col) of every nonzero, unpacked from
        ``packed`` (read through an int32 view: torch has no uint32
        shifts)."""
        p = self.packed.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        return (p >> 16).to(torch.int32), (p & 0xFFFF).to(torch.int32)

    def block_of_nnz(self) -> torch.Tensor:
        k = torch.arange(self.nnz, dtype=torch.int32, device=self.device)
        return (torch.searchsorted(self.block_ptr, k, right=True) - 1
                ).to(torch.int32)

    def global_rows_cols(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """int64 (row, col) of every nonzero, in storage order."""
        bid = self.block_of_nnz().long()
        lr, lc = self.local_rows_cols()
        return (self.block_rows.long()[bid] * self.beta + lr,
                self.block_cols.long()[bid] * self.beta + lc)

    def to_coo(self) -> COO:
        rows, cols = self.global_rows_cols()
        return COO(rows.to(torch.int32), cols.to(torch.int32), self.data,
                   self.shape)

    def storage_bytes(self) -> int:
        """Paper-faithful storage cost of the *variant's own* scheme (not the
        canonical arrays): data + in-block indices + block-level
        structure."""
        b = self.nnz * self.data.element_size()
        if self.in_block_format == IN_BLOCK_PACKED_COO:
            b += self.nnz * 4                          # 16+16 packed
        else:                                          # in-block ICRS
            b += self.nnz * 2                          # 16-bit col_inc
            b += self.num_blocks * 2 * 2               # start + avg jumps
        if self.block_storage == BLOCK_STORAGE_DENSE_PTR:
            b += (self.grid[0] * self.grid[1] + 1) * 4
        elif self.block_storage == BLOCK_STORAGE_BICRS:
            b += self.num_blocks * 4                   # block_nnz 32-bit
            b += self.blk_col_inc.shape[0] * 2         # 16-bit increments
            b += self.blk_row_jump.shape[0] * 2
        else:                                          # block CSR
            b += (self.grid[0] + 1) * 4 + self.num_blocks * 4
            b += self.num_blocks * 4                   # block ptr data array
        return int(b)
