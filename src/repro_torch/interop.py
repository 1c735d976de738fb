"""Carry the JAX package's storage across to the port.

The reference's storage objects are pytrees of JAX arrays. The caller
turns each field into numpy (``np.asarray(obj.field)``) and passes a dict
keyed by the reference's field names; these functions build the port's
objects from it on ``device``. Nothing here imports JAX.

* :func:`coo_from_arrays`   {rows, cols, data, shape}
* :func:`csr_from_arrays`   {row_ptr, col_ind, data, shape}
* :func:`sellcs_from_arrays` {data, cols, slice_ptr, slice_of, row_perm,
  row_len, shape, chunk, sigma, nnz[, diag, structure]}
* :func:`merge_plan_from_arrays` {cols, vals, seg, row_starts, r_width}
* :func:`tiled_from_arrays`  {tiles, tile_rows, tile_cols, shape, beta,
  order, nnz} (f32 or bf16 tiles)
* :func:`blocked_from_arrays` {block_rows, block_cols, block_ptr, packed,
  data, grid_ptr, blk_col_inc, blk_row_jump, blk_row_ptr, shape, beta,
  grid, block_storage, block_order, in_block_format, in_block_order,
  row_bands}
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.formats import COO, CSR, BlockedSparse
from repro_torch.kernels.merge_spmv import MergePlan
from repro_torch.kernels.tiling import TiledSparse
from repro_torch.spmm.sellcs import SellCS


def _t(a, dev, dtype=None) -> torch.Tensor:
    arr = np.array(a, dtype=dtype, copy=True)    # writable, contiguous
    return torch.from_numpy(arr).to(dev)


def coo_from_arrays(d: Mapping, device: DeviceLike = None) -> COO:
    dev = resolve_device(device)
    r = np.asarray(d["rows"], np.int32)
    c = np.asarray(d["cols"], np.int32)
    v = np.asarray(d["data"])
    return COO(_t(r, dev), _t(c, dev), _t(v, dev),
               tuple(int(s) for s in d["shape"]), host=(r, c, v))


def csr_from_arrays(d: Mapping, device: DeviceLike = None) -> CSR:
    dev = resolve_device(device)
    rp = np.asarray(d["row_ptr"], np.int32)
    ci = np.asarray(d["col_ind"], np.int32)
    v = np.asarray(d["data"])
    return CSR(_t(rp, dev), _t(ci, dev), _t(v, dev),
               tuple(int(s) for s in d["shape"]), host=(rp, ci, v))


def sellcs_from_arrays(d: Mapping, device: DeviceLike = None) -> SellCS:
    dev = resolve_device(device)
    diag = d.get("diag")
    return SellCS(
        data=_t(d["data"], dev), cols=_t(d["cols"], dev, np.int32),
        slice_ptr=_t(d["slice_ptr"], dev, np.int32),
        slice_of=_t(d["slice_of"], dev, np.int32),
        row_perm=_t(d["row_perm"], dev, np.int32),
        row_len=_t(d["row_len"], dev, np.int32),
        diag=None if diag is None else _t(diag, dev),
        shape=tuple(int(s) for s in d["shape"]), chunk=int(d["chunk"]),
        sigma=int(d["sigma"]), nnz=int(d["nnz"]),
        structure=str(d.get("structure", "general")))


def span_lengths(seg: np.ndarray, row_starts: np.ndarray) -> np.ndarray:
    """Real item count per span of a reference plan, which stores none:
    items are row-sorted, so within a span ``seg`` never decreases until
    the padding (seg == 0) starts. A span whose real items all sit in
    local row 0 keeps its padding in the count, which adds only
    ``0 * x[0]`` to that same row; a span starting at row m
    (``row_starts[-1]``) holds no items at all."""
    seg = np.asarray(seg, np.int64)
    row_starts = np.asarray(row_starts, np.int64)
    P, D = seg.shape
    drop = np.zeros((P, D), bool)
    drop[:, 1:] = seg[:, 1:] < seg[:, :-1]
    first = np.where(drop.any(axis=1), drop.argmax(axis=1), D)
    first[row_starts[:-1] >= row_starts[-1]] = 0
    return first.astype(np.int32)


def merge_plan_from_arrays(d: Mapping, device: DeviceLike = None
                           ) -> MergePlan:
    dev = resolve_device(device)
    seg = np.asarray(d["seg"], np.int32)
    return MergePlan(_t(d["cols"], dev, np.int32), _t(d["vals"], dev),
                     _t(seg, dev), _t(d["row_starts"], dev, np.int32),
                     _t(span_lengths(seg, d["row_starts"]), dev), int(d["r_width"]))


def _float_t(a, dev) -> torch.Tensor:
    """A float array as a tensor; numpy's bfloat16 (the ml_dtypes type JAX
    hands out) crosses as its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _t(a.view(np.uint16), dev).view(torch.bfloat16)
    return _t(a, dev)


def tiled_from_arrays(d: Mapping, device: DeviceLike = None) -> TiledSparse:
    dev = resolve_device(device)
    return TiledSparse(
        tiles=_float_t(d["tiles"], dev),
        tile_rows=_t(d["tile_rows"], dev, np.int32),
        tile_cols=_t(d["tile_cols"], dev, np.int32),
        shape=tuple(int(s) for s in d["shape"]), beta=int(d["beta"]),
        order=str(d["order"]), nnz=int(d["nnz"]))


def blocked_from_arrays(d: Mapping, device: DeviceLike = None
                        ) -> BlockedSparse:
    dev = resolve_device(device)
    packed = np.asarray(d["packed"], np.uint32).view(np.int32)
    return BlockedSparse(
        block_rows=_t(d["block_rows"], dev, np.int32),
        block_cols=_t(d["block_cols"], dev, np.int32),
        block_ptr=_t(d["block_ptr"], dev, np.int32),
        packed=_t(packed, dev).view(torch.uint32),
        data=_t(d["data"], dev),
        grid_ptr=_t(d["grid_ptr"], dev, np.int32),
        blk_col_inc=_t(d["blk_col_inc"], dev, np.int32),
        blk_row_jump=_t(d["blk_row_jump"], dev, np.int32),
        blk_row_ptr=_t(d["blk_row_ptr"], dev, np.int32),
        shape=tuple(int(s) for s in d["shape"]), beta=int(d["beta"]),
        grid=tuple(int(g) for g in d["grid"]),
        block_storage=str(d["block_storage"]),
        block_order=str(d["block_order"]),
        in_block_format=str(d["in_block_format"]),
        in_block_order=str(d["in_block_order"]),
        row_bands=tuple(int(b) for b in d.get("row_bands", ())))
