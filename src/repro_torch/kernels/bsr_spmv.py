"""Tiled SpMV (K5) and multi-RHS SpMM (K7) over ``TiledSparse``.

* :func:`bsr_spmv` — K5, replaces ``repro.kernels.bsr_spmv.bsr_spmv`` /
  ``_kernel``: ``y[r*8 : +8] += tile @ x[c*128 : +128]`` per stored tile.
* :func:`bsr_spmm` — K7, replaces ``repro.kernels.bsr_spmv.bsr_spmm`` /
  ``_kernel_spmm``: the same for X [n, R], the whole R in one block.

Both are CUDA C++ in ``repro_torch/csrc/tiled_spmm.cu`` (see its notes for
the bound and the design); K6, the k-tiled form behind ``spmm()``, is
``repro_torch.spmm.kernels.tiled_spmm`` and launches the same entry point
as K7: its column tile is checked there and never reaches the kernel,
which reads the tile stream once for all k columns. K5 reads a zero-free
copy of the tile stream instead of the dense tiles (:func:`_compact_tiles`,
built once per ``TiledSparse`` at its first K5 launch and kept on it). A
NaN or Inf in X reaches the rows of every stored tile over its 128-row X
block, through the tile's stored zeros, as in the reference's dense tile
product. As in the Pallas kernels, x is rounded to the tile dtype before
the product, products accumulate in float32 and the result is float32.
Each wrapper runs its plain PyTorch version (the ``*_plain`` functions)
only for CPU tensors; a CUDA tensor launches the kernel or raises.
Launches are counted in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional, Tuple

import torch

from . import _lib
from .tiling import TILE_C, TILE_R, TiledSparse

# tile dtype -> the code the C entry points take
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# plain-version work is chunked over tiles so its [t, 128, k] gather and
# f32 tile copy stay below this many elements
_PLAIN_CHUNK_ELEMS = 1 << 25


def tiled_products_plain(tiles: torch.Tensor, tile_rows: torch.Tensor,
                         tile_cols: torch.Tensor, x2: torch.Tensor,
                         shape: Tuple[int, int]) -> torch.Tensor:
    """The function K5, K6 and K7 compute, for X ``x2`` [n, k]: X rounded
    to the tile dtype, each tile's (8, 128) @ (128, k) product in float32,
    added into its 8 rows -> f32 [m, k]."""
    m, n = shape
    mp = -(-m // TILE_R) * TILE_R
    np_ = -(-n // TILE_C) * TILE_C
    k = int(x2.shape[1])
    dev = x2.device
    x_pad = torch.zeros((np_, k), dtype=torch.float32, device=dev)
    x_pad[:n] = x2.to(tiles.dtype).to(torch.float32)
    xv = x_pad.view(np_ // TILE_C, TILE_C, k)
    y = torch.zeros((mp // TILE_R, TILE_R, k), dtype=torch.float32,
                    device=dev)
    T = int(tiles.shape[0])
    step = max(_PLAIN_CHUNK_ELEMS // (TILE_C * k + TILE_R * TILE_C), 1)
    for t0 in range(0, T, step):
        sl = slice(t0, min(t0 + step, T))
        contrib = torch.einsum("trc,tck->trk", tiles[sl].to(torch.float32),
                               xv[tile_cols[sl].long()])
        y.index_add_(0, tile_rows[sl].long(), contrib)
    return y.view(mp, k)[:m]


def bsr_spmv_plain(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: x [n] -> f32 [m]."""
    return tiled_products_plain(ts.tiles, ts.tile_rows, ts.tile_cols,
                                x[:, None], ts.shape)[:, 0]


def bsr_spmm_plain(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: X [n, R] -> f32 [m, R]."""
    return tiled_products_plain(ts.tiles, ts.tile_rows, ts.tile_cols, x,
                                ts.shape)


# tiles per chunk of K5; each entry of its operand carries its tile's
# index modulo this above the 10 bits of its in-tile position
_K5_CHUNK = 32
# the operand's entries are padded to a multiple of this (K5 loads 8
# consecutive entries at once)
_K5_ALIGN = 8
# most entries one warp of K5 takes: a chunk with more (mawi_like's dense
# row: 32 tiles of 128+ nonzeros) is split over several warps
_K5_ITEM = 1024


@dataclasses.dataclass(eq=False)
class _CompactTiles:
    """K5's operand: the stored nonzeros of a tile stream, tile by tile in
    visit order, each tile's in row-major order. Entry e of tile t holds
    ``pos[e] = (t % 32) << 10 | r << 7 | c`` and ``vals[e] = tile[t, r,
    c]`` (the tile dtype), for e in ``nz_ptr[t] : nz_ptr[t + 1]``; ``pos``
    and ``vals`` are zero-padded to a multiple of 8 entries. ``work`` is
    the kernel's warps' work: per item, a chunk of 32 tiles and the span
    ``lo : hi`` of its entries (lo a multiple of 8, at most 1,024
    entries), the chunk's items in order and covering its entries."""
    sources: tuple             # (tiles, tile_rows, tile_cols) it was
                               # built and checked from
    version: int               # ``tiles._version`` then
    nz_ptr: torch.Tensor       # int32[T + 1]
    work: torch.Tensor         # int32[I, 3]: chunk, lo, hi
    pos: torch.Tensor          # int16[L] (u16 bits; every value < 2**15)
    vals: torch.Tensor         # tile dtype [L]
    nnz: int                   # stored nonzeros (nz_ptr[T])
    code: int                  # the tile dtype's code for the C entry
    build_s: float             # seconds to build (device synchronized)
    _args: Optional[tuple] = dataclasses.field(default=None, init=False,
                                               repr=False)

    def stream_args(self) -> tuple:
        """The C entry's leading arguments, as ctypes values made once:
        the operand's pointers, the tile dtype code and the tile indices'
        pointers."""
        if self._args is None:
            tiles, rows, cols = self.sources
            P = ctypes.c_void_p
            self._args = (P(self.nz_ptr.data_ptr()), P(self.pos.data_ptr()),
                          P(self.vals.data_ptr()), P(self.work.data_ptr()),
                          ctypes.c_int(int(self.work.shape[0])),
                          P(tiles.data_ptr()), ctypes.c_int(self.code),
                          P(rows.data_ptr()), P(cols.data_ptr()))
        return self._args

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.nz_ptr, self.work, self.pos, self.vals))


def _compact_tiles(ts: TiledSparse) -> _CompactTiles:
    """The zero-free operand of ``ts``, built on its device at the first
    call and kept on it (``ts._compact``); rebuilt when the tiles or
    their indices are replaced or the tiles changed in place, so it is
    never stale. Conversion, not a kernel: torch ops over the tiles,
    once."""
    c = ts._compact
    sources = (ts.tiles, ts.tile_rows, ts.tile_cols)
    if (c is not None and c.version == ts.tiles._version
            and all(a is b for a, b in zip(c.sources, sources))):
        return c
    dev = ts.tiles.device
    code = _check_tiled(ts) if dev.type == "cuda" else _dtype_code(ts)
    t0 = time.perf_counter()
    T = ts.num_tiles
    flat = ts.tiles.reshape(-1)
    idx = torch.nonzero(flat != 0).squeeze(1)       # tile-major, then r, c
    tile = idx // (TILE_R * TILE_C)
    nz_ptr = torch.zeros(T + 1, dtype=torch.int32, device=dev)
    nz_ptr[1:] = torch.bincount(tile, minlength=T).cumsum(0)
    nnz = int(idx.numel())
    L = max(-(-nnz // _K5_ALIGN) * _K5_ALIGN, _K5_ALIGN)
    pos = torch.zeros(L, dtype=torch.int16, device=dev)
    pos[:nnz] = ((tile % _K5_CHUNK) * (TILE_R * TILE_C)
                 + idx % (TILE_R * TILE_C)).to(torch.int16)
    vals = torch.zeros(L, dtype=ts.tiles.dtype, device=dev)
    vals[:nnz] = flat[idx]
    # the work items: each chunk's entries from its first (rounded down to
    # a multiple of 8) in spans of at most _K5_ITEM, at least one a chunk
    starts = torch.arange(0, T, _K5_CHUNK, device=dev)
    a = nz_ptr[starts].long() & ~(_K5_ALIGN - 1)
    e1 = nz_ptr[(starts + _K5_CHUNK).clamp(max=T)].long()
    n_items = (-(-(e1 - a) // _K5_ITEM)).clamp(min=1)
    chunk = torch.repeat_interleave(torch.arange(starts.numel(),
                                                 device=dev), n_items)
    first = torch.cumsum(n_items, 0) - n_items
    lo = a[chunk] + (torch.arange(chunk.numel(), device=dev)
                     - first[chunk]) * _K5_ITEM
    work = torch.stack([chunk, lo, torch.minimum(lo + _K5_ITEM, e1[chunk])],
                       1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    c = _CompactTiles(sources, ts.tiles._version, nz_ptr, work, pos, vals,
                      nnz, code, time.perf_counter() - t0)
    ts._compact = c
    return c


def _dtype_code(ts: TiledSparse) -> int:
    code = _DTYPE_CODE.get(ts.tiles.dtype)
    if code is None:
        raise TypeError(f"tiles must be one of {tuple(_DTYPE_CODE)}, got "
                        f"{ts.tiles.dtype}")
    return code


def _check_tiled(ts: TiledSparse) -> int:
    """Validate the tile stream before its pointers go to C; returns the
    tile dtype code."""
    code = _dtype_code(ts)
    _lib.require(ts.tiles, "tiles", ts.tiles.dtype, 3)
    _lib.require(ts.tile_rows, "tile_rows", torch.int32, 1)
    _lib.require(ts.tile_cols, "tile_cols", torch.int32, 1)
    T = ts.num_tiles
    if ts.tiles.shape[1:] != (TILE_R, TILE_C):
        raise ValueError(f"tiles must be [T, {TILE_R}, {TILE_C}], got "
                         f"{tuple(ts.tiles.shape)}")
    if ts.tile_rows.shape[0] != T or ts.tile_cols.shape[0] != T:
        raise ValueError("tile_rows / tile_cols must have one entry per "
                         "tile")
    if ts.tiles.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned")
    return code


def _operand(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x`` as a contiguous, 16-byte aligned float32 CUDA tensor."""
    x = x.to(torch.float32).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    _lib.require(x, "x", torch.float32, ndim)
    return x


def tiled_spmm_launch(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """Launch the tiled SpMM entry point for X [n, k] -> f32 [m, k]. The
    kernel reads the tile stream once for all k columns, so it takes no
    column tile. Counts nothing: K6 and K7 count their own launches."""
    code = _check_tiled(ts)
    x = _operand(x, 2)
    m, n = ts.shape
    mp, _ = ts.padded_shape()
    k = int(x.shape[1])
    if x.shape[0] != n:
        raise ValueError(f"X must be [{n}, k], got {tuple(x.shape)}")
    y = torch.zeros((mp, k), dtype=torch.float32, device=x.device)
    # one finite flag per 128-row X block, written by the kernel's pre-pass
    finite = torch.empty(-(-n // TILE_C), dtype=torch.int32, device=x.device)
    fn = "tiled_spmm_launch"
    _lib.check(_lib.entry(fn)(
        ts.tiles.data_ptr(), code, ts.tile_rows.data_ptr(),
        ts.tile_cols.data_ptr(), x.data_ptr(), finite.data_ptr(),
        y.data_ptr(), ts.num_tiles, n, k, _lib.sm_count(x.device),
        _lib.stream_of(x)), fn)
    return y[:m]


def bsr_spmv(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """K5: ``y = A x`` over the tile stream, x [n] -> f32 [m]. Reads the
    stream's zero-free operand (:func:`_compact_tiles`, built at the first
    launch). The adds into y are atomic, so their order (and the last
    bits) vary from run to run."""
    m, n = ts.shape
    if x.shape != (n,):
        raise ValueError(f"x must be [{n}], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bsr_spmv_plain(ts, x)
    c = _compact_tiles(ts)
    x = _operand(x, 1)
    mp, _ = ts.padded_shape()
    # y (zeroed by the entry), then one finite flag (int32) per 128-row X
    # block for the kernel's pre-pass: one allocation
    buf = torch.empty(mp + -(-n // TILE_C), dtype=torch.float32,
                      device=x.device)
    fn = "tiled_spmv_launch"
    _lib.check(_lib.entry(fn)(
        *c.stream_args(), x.data_ptr(), buf.data_ptr() + 4 * mp,
        buf.data_ptr(), ts.num_tiles, n, mp, _lib.stream_of(x)), fn)
    bsr_spmv.launches += 1
    return buf[:m]


bsr_spmv.launches = 0


def bsr_spmm(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """K7: ``Y = A X`` for X [n, R] with the whole R in one column tile ->
    f32 [m, R]. Atomic adds, as in K5."""
    if x.ndim != 2:
        raise ValueError(f"X must be [n, R], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bsr_spmm_plain(ts, x)
    y = tiled_spmm_launch(ts, x)
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0
