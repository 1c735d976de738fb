"""TiledSparse — the compute format of the paper's blocked algorithms.

The paper's CPU algorithms do per-nonzero ``y[r] += v * x[c]``. Their
compute form here, as in the JAX package, is hierarchical:

  level 0  (paper: sparse block, cache-sized)   macro block, beta x beta
  level 1                                       dense 8 x 128 mini-tiles

Only nonempty mini-tiles are stored (dense, zero-filled), and the product
per mini-tile is a dense (8, 128) @ (128, k) block. The 8 x 128 shape is
the reference's (its TPU register tile), kept so that the stored stream
equals the reference's tile for tile; a shape chosen for Hopper is a
measured later change. What survives of each paper algorithm:

  * blocking       -> beta chooses the x/y slab reuse distance;
  * nonzero order  -> the mini-tile visit order (row / Morton / Hilbert at
                      both macro and in-macro level) sets how often the x-
                      and y-windows move (``window_switches``), which the
                      kernels (``csrc/tiled_spmm.cu``) keep as their stream
                      order;
  * load balancing -> uniform work quanta (every tile = same FLOPs); a
                      single dense row is split across many tiles (the
                      mawi fix).

The price is fill-in: ``fill_ratio`` = nnz / (1024 * num_tiles).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.convert import ALGORITHM_SPECS, block_size_for
from repro_torch.core.curves import hilbert_key_np
from repro_torch.core.formats import COO, host_arrays
from repro_torch.core.mergepath import balanced_row_bands

TILE_R = 8
TILE_C = 128
TILE_DTYPES = (torch.float32, torch.bfloat16)


def _morton_key_np(rows, cols, bits):
    """int64 Morton key of the tiled conversion (the blocked conversion's
    twin in ``core.convert`` returns uint64; each keeps the reference's
    dtype so both lexsort orders match)."""
    r = np.asarray(rows, np.uint64)
    c = np.asarray(cols, np.uint64)
    key = np.zeros(r.shape, np.uint64)
    for b in range(bits):
        key |= ((r >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
        key |= ((c >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
    return key.astype(np.int64)


@dataclasses.dataclass(eq=False)
class TiledSparse:
    """Dense 8x128 mini-tiles of an unstructured sparse matrix, in the
    visit order of the paper algorithm that ordered them."""
    tiles: torch.Tensor         # f32 or bf16 [T, 8, 128]
    tile_rows: torch.Tensor     # int32[T] — global tile-row index (row // 8)
    tile_cols: torch.Tensor     # int32[T] — global tile-col index (col // 128)
    shape: Tuple[int, int]
    beta: int                   # macro block size used for ordering
    order: str                  # algorithm preset name
    nnz: int                    # true nonzeros (before fill-in)
    # K5's zero-free copy of the tile stream, built at its first launch
    # (``kernels.bsr_spmv._compact_tiles``); not part of the format
    _compact: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def num_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @property
    def fill_ratio(self) -> float:
        t = self.num_tiles
        return self.nnz / (t * TILE_R * TILE_C) if t else 0.0

    def padded_shape(self) -> Tuple[int, int]:
        m, n = self.shape
        return (-(-m // TILE_R) * TILE_R, -(-n // TILE_C) * TILE_C)

    def window_switches(self) -> Tuple[int, int]:
        """(#x-window moves, #y-window moves) across the tile visit order —
        the count of times the stream moves to another column / row of
        tiles, the proxy for the paper's cache-miss counts."""
        tr = host_arrays(self.tile_rows)
        tc = host_arrays(self.tile_cols)
        if tr.size <= 1:
            return (tr.size, tr.size)
        return (int(np.sum(tc[1:] != tc[:-1]) + 1),
                int(np.sum(tr[1:] != tr[:-1]) + 1))

    def storage_bytes(self) -> int:
        return int(self.tiles.numel() * self.tiles.element_size()
                   + 2 * 4 * self.num_tiles)


def coo_to_tiled(coo: COO, algorithm: str = "csb", *,
                 beta: Optional[int] = None, num_bands: int = 0,
                 dtype: torch.dtype = torch.float32,
                 max_bytes: int = 8 * 2 ** 30) -> TiledSparse:
    """Convert COO -> TiledSparse with the visit order of ``algorithm``
    (any blocked ALGORITHM_SPECS key; flat 'merge'/'parcrs' get row order).

    The ordering runs in numpy on the host, as in the reference; the tiles
    are filled on the COO's device. Raises ``MemoryError`` when the f32
    tiles would exceed ``max_bytes`` (the reference's density rule: below
    that fill the gather-based formats are the better choice)."""
    if dtype not in TILE_DTYPES:
        raise TypeError(f"tile dtype must be one of {TILE_DTYPES}, got "
                        f"{dtype}")
    spec = ALGORITHM_SPECS[algorithm]
    m, n = coo.shape
    if beta is None:
        beta = block_size_for(coo.shape,
                              in_block_format=spec.in_block_format)
    beta = max(beta, TILE_C)            # a macro block holds >=1 tile column

    r0, c0, v0 = coo.host_triplets()
    rows = np.asarray(r0, np.int64)
    cols = np.asarray(c0, np.int64)

    tr, tc = rows // TILE_R, cols // TILE_C           # mini-tile coords
    Nt_c = -(-n // TILE_C)
    tile_key = tr * Nt_c + tc                          # tile identity

    # ordering key: (band, macro curve key, in-macro tile curve key)
    mb_r, mb_c = rows // beta, cols // beta
    Mb, Nb = -(-m // beta), -(-n // beta)
    grid_bits = max(int(np.ceil(np.log2(max(Mb, Nb, 2)))), 1)
    # tile coords within the macro block
    ltr = tr - mb_r * (beta // TILE_R)
    ltc = tc - mb_c * (beta // TILE_C)
    loc_bits = max(int(np.ceil(np.log2(max(beta // TILE_R,
                                           beta // TILE_C, 2)))), 1)

    border = spec.block_order if spec.blocked else "row"
    iorder = spec.in_block_order if spec.blocked else "row"
    if border == "hilbert":
        mkey = hilbert_key_np(mb_r, mb_c, grid_bits)
    elif border == "morton":
        mkey = _morton_key_np(mb_r, mb_c, grid_bits)
    else:
        mkey = mb_r * Nb + mb_c
    if iorder == "hilbert":
        lkey = hilbert_key_np(ltr, ltc, loc_bits)
    elif iorder == "morton":
        lkey = _morton_key_np(ltr, ltc, loc_bits)
    else:
        lkey = ltr * (beta // TILE_C + 1) + ltc

    if num_bands > 0:
        blk_row_ptr = np.zeros(Mb + 1, np.int64)
        np.cumsum(np.bincount(mb_r, minlength=Mb), out=blk_row_ptr[1:])
        bands = balanced_row_bands(blk_row_ptr, num_bands)
        band = np.searchsorted(bands, mb_r, side="right") - 1
    else:
        band = np.zeros(rows.size, np.int64)

    perm = np.lexsort((lkey, mkey, band))
    rows, cols, tile_key = rows[perm], cols[perm], tile_key[perm]

    # unique tiles, ranked by their first visit in the sorted stream
    uniq, first_idx = np.unique(tile_key, return_index=True)
    order_of_uniq = np.argsort(first_idx, kind="stable")
    rank = np.empty(uniq.size, np.int64)
    rank[order_of_uniq] = np.arange(uniq.size)
    inv = rank[np.searchsorted(uniq, tile_key)]

    T = uniq.size
    if T * TILE_R * TILE_C * 4 > max_bytes:
        raise MemoryError(
            f"TiledSparse would need {T * TILE_R * TILE_C * 4 / 2**30:.1f} "
            f"GiB (fill ratio {rows.size / max(T * 1024, 1):.2e}); use a "
            "gather-based format for this density")

    uniq_in_order = uniq[order_of_uniq]
    tile_rows = (uniq_in_order // Nt_c).astype(np.int32)
    tile_cols = (uniq_in_order % Nt_c).astype(np.int32)
    if T == 0:
        tile_rows = np.zeros(1, np.int32)
        tile_cols = np.zeros(1, np.int32)

    dev = coo.device
    tiles = torch.zeros((max(T, 1), TILE_R, TILE_C), dtype=torch.float32,
                        device=dev)
    if T:
        idx = (torch.from_numpy(inv).to(dev),
               torch.from_numpy(rows % TILE_R).to(dev),
               torch.from_numpy(cols % TILE_C).to(dev))
        vals = torch.from_numpy(
            np.asarray(v0)[perm].astype(np.float32)).to(dev)
        tiles.index_put_(idx, vals, accumulate=True)
    return TiledSparse(
        tiles=tiles.to(dtype), tile_rows=torch.from_numpy(tile_rows).to(dev),
        tile_cols=torch.from_numpy(tile_cols).to(dev), shape=coo.shape,
        beta=int(beta), order=algorithm, nnz=int(rows.size))
