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
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.formats import COO, CSR
from repro_torch.kernels.merge_spmv import MergePlan
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
