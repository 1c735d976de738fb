"""Storage format conversion (paper §5.1, Tables 6.4/6.5), host side.

Conversion = (1) sort nonzeros into the target ordering, (2) populate the
target arrays (compress indices, build pointers). Step (1) dominates —
O(nnz log nnz) — exactly as in the paper. It runs in numpy on the host, as
in the JAX package, and the result moves to the target device once. Each
flat object keeps the host arrays it was built from, so later host
planning (the merge plan) never copies them back from the card.

The nine paper algorithms (plus ``sellcs``) map to conversion presets in
``ALGORITHM_SPECS``; :func:`convert` is the uniform entry point.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import curves
from .device import DeviceLike, resolve_device
from .formats import (BICRS, BLOCK_STORAGE_BICRS, BLOCK_STORAGE_CSR,
                      BLOCK_STORAGE_DENSE_PTR, COO, CSR, ICRS,
                      IN_BLOCK_ICRS, IN_BLOCK_PACKED_COO, BlockedSparse)
from .mergepath import balanced_row_bands


# --------------------------------------------------------------------------
# Algorithm presets: the 3 state-of-the-art + 6 hybrids (paper §3, §4)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    blocked: bool
    block_storage: str = BLOCK_STORAGE_DENSE_PTR
    block_order: str = "row"            # storage/visit order of blocks
    in_block_format: str = IN_BLOCK_PACKED_COO
    in_block_order: str = "row"
    scheduling: str = "dynamic"         # dynamic | static_rows | merge
    note: str = ""


ALGORITHM_SPECS = {
    # CRS-based
    "parcrs": AlgorithmSpec("parcrs", blocked=False, scheduling="dynamic",
                            note="OpenMP-dynamic row loop"),
    "merge": AlgorithmSpec("merge", blocked=False, scheduling="merge",
                           note="merge-path on flat CSR [Merrill&Garland]"),
    # CSB family
    "csb": AlgorithmSpec("csb", True, BLOCK_STORAGE_DENSE_PTR, "row",
                         IN_BLOCK_PACKED_COO, "morton", "dynamic",
                         "Buluc et al. 2009"),
    "csbh": AlgorithmSpec("csbh", True, BLOCK_STORAGE_DENSE_PTR, "row",
                          IN_BLOCK_PACKED_COO, "hilbert", "dynamic",
                          "hybrid #1: CSB with Hilbert inside blocks"),
    # BCOH family
    "bcoh": AlgorithmSpec("bcoh", True, BLOCK_STORAGE_BICRS, "hilbert",
                          IN_BLOCK_ICRS, "row", "static_rows",
                          "Yzelman&Roose 2014 (in-block ICRS counted as "
                          "storage; multiplied through the canonical "
                          "arrays)"),
    "bcohc": AlgorithmSpec("bcohc", True, BLOCK_STORAGE_BICRS, "hilbert",
                           IN_BLOCK_PACKED_COO, "row", "static_rows",
                           "hybrid #2: BCOH with packed-COO compression"),
    "bcohch": AlgorithmSpec("bcohch", True, BLOCK_STORAGE_BICRS, "hilbert",
                            IN_BLOCK_PACKED_COO, "hilbert", "static_rows",
                            "hybrid #3: per-band global Hilbert sort"),
    "bcohchp": AlgorithmSpec("bcohchp", True, BLOCK_STORAGE_DENSE_PTR,
                             "hilbert", IN_BLOCK_PACKED_COO, "hilbert",
                             "static_rows",
                             "hybrid #4: dense Hilbert-ordered block ptr"),
    # Merge-blocked family
    "mergeb": AlgorithmSpec("mergeb", True, BLOCK_STORAGE_CSR, "row",
                            IN_BLOCK_PACKED_COO, "row", "merge",
                            "hybrid #5: merge-path over block CSR"),
    "mergebh": AlgorithmSpec("mergebh", True, BLOCK_STORAGE_CSR, "row",
                             IN_BLOCK_PACKED_COO, "hilbert", "merge",
                             "hybrid #6: + Hilbert inside blocks"),
    # SELL-C-σ: the row-sorted sliced-ELL storage of the multi-RHS engine
    "sellcs": AlgorithmSpec("sellcs", blocked=False, scheduling="dynamic",
                            note="SELL-C-σ slices (Kreutzer et al.) — "
                                 "converted by repro_torch.spmm.sellcs"),
}

# Budget for the x and y slabs of one block, the paper's "x and y regions
# fit comfortably in L2" (§3.1): the H100's 50 MB L2 (NVIDIA data sheet).
# Blocks are at most 2**16 wide (16-bit packed indices), so the slabs stay
# <= 512 KiB and this rule never lowers beta below the index-width cap.
L2_BUDGET_BYTES = 50 * 2 ** 20


def block_size_for(shape: Tuple[int, int], *, in_block_format: str,
                   dtype_bytes: int = 4,
                   slab_budget: int = L2_BUDGET_BYTES,
                   min_beta: int = 1) -> int:
    """Paper Eq. (3.1) + constraints: start at the upper bound
    log2(beta) = 3 + ceil(log2(sqrt(n))) and lower until (a) packed indices
    fit 16 bits (15 for ICRS overflow headroom), (b) the x and y slabs fit
    ``slab_budget``."""
    n = max(shape[1], 2)
    ub = 3 + math.ceil(math.log2(math.sqrt(n)))
    cap = 15 if in_block_format == IN_BLOCK_ICRS else 16
    log_beta = min(ub, cap)
    while log_beta > 0:
        beta = 1 << log_beta
        slabs = 2 * beta * dtype_bytes
        if slabs <= slab_budget:
            break
        log_beta -= 1
    return max(1 << log_beta, min_beta)


# --------------------------------------------------------------------------
# Flat conversions
# --------------------------------------------------------------------------
def coo_canonicalize_np(rows, cols, vals, shape):
    """Sort row-major and sum duplicates (host)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        key = rows * shape[1] + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.size != rows.size:
            out = np.zeros(uniq.size, vals.dtype)
            np.add.at(out, inv, vals)
            rows, cols, vals = uniq // shape[1], uniq % shape[1], out
    return rows.astype(np.int32), cols.astype(np.int32), vals


_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16}


def to_coo(rows, cols, vals, shape, dtype=torch.float32,
           device: DeviceLike = None) -> COO:
    """Canonical COO on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    r, c, v = coo_canonicalize_np(rows, cols, vals, shape)
    v = v.astype(_NP_OF_TORCH.get(dtype, np.float32))
    return COO(torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev),
               torch.from_numpy(v).to(dev, dtype), tuple(shape),
               host=(r, c, v))


def coo_to_csr(coo: COO) -> CSR:
    m, n = coo.shape
    rows, cols, vals = coo.host_triplets()
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    cols = cols.astype(np.int32)
    dev = coo.device
    return CSR(torch.from_numpy(row_ptr).to(dev),
               torch.from_numpy(cols).to(dev),
               torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
               coo.shape, host=(row_ptr, cols, vals))


def _encode_incremental(rows, cols, n):
    """Shared ICRS/BICRS encoder. Returns (col_start, col_inc, row_jump).
    col_inc[k] = col(k+1) - col(k), plus n exactly once when the row changes
    (signals the decoder to consume the next row_jump). row_jump =
    [start_row, delta_1, ...]. The final increment is a dummy 0."""
    nnz = rows.size
    if nnz == 0:
        return 0, np.zeros(0, np.int32), np.zeros(1, np.int32)
    col_inc = np.zeros(nnz, np.int64)
    dcol = cols[1:].astype(np.int64) - cols[:-1].astype(np.int64)
    drow = rows[1:].astype(np.int64) - rows[:-1].astype(np.int64)
    change = drow != 0
    col_inc[:-1] = dcol + np.where(change, n, 0)
    row_jump = np.concatenate([[rows[0]], drow[change]])
    return int(cols[0]), col_inc.astype(np.int32), row_jump.astype(np.int32)


def _incremental(cls, coo: COO, rows, cols, vals):
    cs, ci, rj = _encode_incremental(rows, cols, coo.shape[1])
    dev = coo.device
    return cls(cs, torch.from_numpy(ci).to(dev), torch.from_numpy(rj).to(dev),
               torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
               coo.shape)


def coo_to_icrs(coo: COO) -> ICRS:
    rows, cols, vals = coo.host_triplets()
    order = np.lexsort((cols, rows))       # ICRS requires row-major order
    rows, cols, vals = rows[order], cols[order], vals[order]
    return _incremental(ICRS, coo, rows, cols, vals)


def coo_to_bicrs(coo: COO, order: str = "hilbert") -> BICRS:
    rows, cols, vals = coo.host_triplets()
    if rows.size:
        bits = max(int(np.ceil(np.log2(max(max(coo.shape), 2)))), 1)
        if order == "hilbert":
            key = curves.hilbert_key_np(rows, cols, bits)
        elif order == "morton":
            key = _morton_key_np(rows, cols, bits)
        else:
            key = rows.astype(np.int64) * coo.shape[1] + cols
        perm = np.argsort(key, kind="stable")
        rows, cols, vals = rows[perm], cols[perm], vals[perm]
    return _incremental(BICRS, coo, rows, cols, vals)


def _morton_key_np(rows, cols, bits):
    """uint64 Morton key of the blocked conversions (the tiled conversion
    keeps its own int64 twin, ``repro_torch.kernels.tiling``, so that both
    lexsort orders match the reference's)."""
    r = np.asarray(rows, np.uint64)
    c = np.asarray(cols, np.uint64)
    key = np.zeros(r.shape, np.uint64)
    for b in range(bits):
        key |= ((r >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
        key |= ((c >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
    return key


# --------------------------------------------------------------------------
# Blocked conversion (the heart of CSB/BCOH/hybrids)
# --------------------------------------------------------------------------
def coo_to_blocked(coo: COO, algorithm: str, *, beta: Optional[int] = None,
                   num_bands: int = 0) -> BlockedSparse:
    """Convert COO to the blocked format of ``algorithm`` (one of the
    blocked ALGORITHM_SPECS keys). ``num_bands`` > 0 enables the BCOH static
    row distribution (bands are block-row aligned so blocks never straddle
    bands)."""
    spec = ALGORITHM_SPECS[algorithm]
    if not spec.blocked:
        raise ValueError(f"{algorithm} is not a blocked algorithm")
    m, n = coo.shape
    if beta is None:
        beta = block_size_for(coo.shape, in_block_format=spec.in_block_format)
    Mb = -(-m // beta)
    Nb = -(-n // beta)

    r0, c0, vals = coo.host_triplets()
    rows = np.asarray(r0).astype(np.int64)
    cols = np.asarray(c0).astype(np.int64)
    br, bc = rows // beta, cols // beta
    lr, lc = rows % beta, cols % beta

    grid_bits = max(int(np.ceil(np.log2(max(Mb, Nb, 2)))), 1)
    local_bits = max(int(np.ceil(np.log2(max(beta, 2)))), 1)

    # ---- sort key: (band, block_key, in_block_key) ------------------------
    if num_bands > 0:
        # block-row-aligned equal-nnz bands (paper §3.2, adapted so a block
        # never straddles a band)
        blk_row_ptr = np.zeros(Mb + 1, np.int64)
        np.cumsum(np.bincount(br.astype(np.int64), minlength=Mb),
                  out=blk_row_ptr[1:])
        bands = balanced_row_bands(blk_row_ptr, num_bands)
        band_of_nnz = (np.searchsorted(bands, br, side="right") - 1)
    else:
        bands = np.array([0, Mb], np.int32)
        band_of_nnz = np.zeros(rows.size, np.int64)

    if spec.block_order == "hilbert":
        block_key = curves.hilbert_key_np(br, bc, grid_bits)
    elif spec.block_order == "morton":
        block_key = _morton_key_np(br, bc, grid_bits)
    else:
        block_key = br * Nb + bc

    if spec.in_block_order == "hilbert":
        if spec.block_order == "hilbert":
            # BCOHCH/BCOHCHP: one global Hilbert sort per band (paper §4.2).
            # beta is a power of two, so every block is a contiguous,
            # aligned segment of the global curve and the induced block
            # order is the Hilbert order of the block grid: sorting by the
            # global key yields both orders at once.
            glob_bits = max(int(np.ceil(np.log2(max(m, n, 2)))), local_bits)
            in_key = curves.hilbert_key_np(rows, cols, glob_bits)
        else:
            in_key = curves.hilbert_key_np(lr, lc, local_bits)
    elif spec.in_block_order == "morton":
        in_key = _morton_key_np(lr, lc, local_bits)
    else:
        in_key = lr * beta + lc
    perm = np.lexsort((in_key, block_key, band_of_nnz))
    br, bc, lr, lc, vals = br[perm], bc[perm], lr[perm], lc[perm], vals[perm]
    block_key = block_key[perm]
    band_of_nnz = band_of_nnz[perm]

    # ---- canonical block arrays ------------------------------------------
    if rows.size:
        bkey_sorted = band_of_nnz * (1 << (2 * grid_bits + 2)) + \
            block_key.astype(np.int64)
        new_blk = np.empty(rows.size, bool)
        new_blk[0] = True
        new_blk[1:] = bkey_sorted[1:] != bkey_sorted[:-1]
        starts = np.flatnonzero(new_blk)
        block_rows = br[starts].astype(np.int32)
        block_cols = bc[starts].astype(np.int32)
        block_ptr = np.concatenate([starts, [rows.size]]).astype(np.int32)
    else:
        block_rows = np.zeros(0, np.int32)
        block_cols = np.zeros(0, np.int32)
        block_ptr = np.zeros(1, np.int32)
    packed = ((lr.astype(np.uint32) << np.uint32(16))
              | lc.astype(np.uint32))

    # ---- variant-specific storage arrays ----------------------------------
    z = np.zeros(0, np.int32)
    grid_ptr = blk_col_inc = blk_row_jump = blk_row_ptr_arr = z
    if spec.block_storage == BLOCK_STORAGE_DENSE_PTR:
        # dense pointer per grid cell, in the storage block order
        gr, gc = np.divmod(np.arange(Mb * Nb, dtype=np.int64), Nb)
        if spec.block_order == "hilbert":
            cell_key = curves.hilbert_key_np(gr, gc, grid_bits)
        elif spec.block_order == "morton":
            cell_key = _morton_key_np(gr, gc, grid_bits).astype(np.int64)
        else:
            cell_key = gr * Nb + gc
        cell_rank = np.argsort(np.argsort(cell_key, kind="stable"))
        nnz_per_cell = np.zeros(Mb * Nb, np.int64)
        if rows.size:
            counts = (block_ptr[1:] - block_ptr[:-1]).astype(np.int64)
            cell_of_block = cell_rank[block_rows.astype(np.int64) * Nb
                                      + block_cols]
            nnz_per_cell[cell_of_block] = counts
        grid_ptr = np.zeros(Mb * Nb + 1, np.int64)
        np.cumsum(nnz_per_cell, out=grid_ptr[1:])
        grid_ptr = grid_ptr.astype(np.int32)
    elif spec.block_storage == BLOCK_STORAGE_BICRS:
        _, blk_col_inc, blk_row_jump = _encode_incremental(
            block_rows.astype(np.int64), block_cols.astype(np.int64), Nb)
    else:  # block CSR (MergeB)
        blk_row_ptr_arr = np.zeros(Mb + 1, np.int64)
        np.cumsum(np.bincount(block_rows.astype(np.int64), minlength=Mb),
                  out=blk_row_ptr_arr[1:])
        blk_row_ptr_arr = blk_row_ptr_arr.astype(np.int32)

    dev = coo.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return BlockedSparse(
        block_rows=t(block_rows), block_cols=t(block_cols),
        block_ptr=t(block_ptr),
        # moved as int32 bits: a uint32 tensor has no device copy kernels
        # in every torch build; the view restores the reference's dtype
        packed=t(packed.view(np.int32)).view(torch.uint32), data=t(vals),
        grid_ptr=t(grid_ptr), blk_col_inc=t(blk_col_inc),
        blk_row_jump=t(blk_row_jump), blk_row_ptr=t(blk_row_ptr_arr),
        shape=coo.shape, beta=int(beta), grid=(int(Mb), int(Nb)),
        block_storage=spec.block_storage, block_order=spec.block_order,
        in_block_format=spec.in_block_format,
        in_block_order=spec.in_block_order,
        row_bands=tuple(int(b) for b in bands),
    )


def convert(coo: COO, algorithm: str, **kw):
    """Uniform entry point: COO -> the storage format ``algorithm`` needs.

    ``sellcs`` goes through ``repro_torch.spmm.sellcs`` (kw: ``c``,
    ``sigma``, ``structure``); blocked algorithms take ``beta`` /
    ``num_bands``; the flat CRS-based algorithms ignore kw."""
    spec = ALGORITHM_SPECS[algorithm]
    if algorithm == "sellcs":
        from repro_torch.spmm.sellcs import coo_to_sellcs   # late: core <- spmm
        return coo_to_sellcs(coo, **kw)
    if spec.blocked:
        return coo_to_blocked(coo, algorithm, **kw)
    return coo_to_csr(coo)
