"""Distributed SpMV over a device mesh — the port of
``repro.core.distributed`` (the paper's multi-socket dimension).

* ``spmv_row_distributed`` (BCOH, §3.2): rows statically banded so each
  shard owns ~nnz/P nonzeros; x replicated, y written shard-locally — no
  sum across shards.
* ``spmv_merge_distributed`` (Merge, §3.3): equal-nnz spans regardless of
  row boundaries; the shards' partial y are summed (the reference's psum,
  the carry-out fixup across shards).

Both multiply through the torch oracles, one shard at a time on its mesh
device (``repro_torch.launch.mesh``), as the reference's ``shard_map``
bodies multiply through jnp; no kernel runs here (the SELL-C-σ schedules
of ``repro_torch.spmm.distributed`` are the kernel path). ``x`` may be
``[n]`` or ``[n, k]``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .formats import COO
from .mergepath import balanced_row_bands


class ShardedCOO(NamedTuple):
    """Per-shard padded COO, stacked along a leading shard axis."""
    rows: torch.Tensor        # int32[P, nnz_pad] — LOCAL row indices
    cols: torch.Tensor        # int32[P, nnz_pad] — global col indices
    vals: torch.Tensor        # f32[P, nnz_pad] — zero-padded
    row_offset: torch.Tensor  # int32[P] — first global row of the shard
    shape: Tuple[int, int]
    rows_per_shard: int       # padded local row count


def _check_devices(num_devices: int) -> None:
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")


def _sorted_triplets(coo: COO):
    r, c, v = coo.host_triplets()
    rows, cols, vals = np.asarray(r), np.asarray(c), np.asarray(v)
    order = np.argsort(rows, kind="stable")
    return rows[order], cols[order], vals[order]


def _stack(R, C, V, offs, coo: COO, rows_per: int) -> ShardedCOO:
    dev = coo.device
    return ShardedCOO(torch.from_numpy(R).to(dev),
                      torch.from_numpy(C).to(dev),
                      torch.from_numpy(V).to(dev),
                      torch.from_numpy(offs.astype(np.int32)).to(dev),
                      tuple(coo.shape), rows_per)


def partition_rows(coo: COO, num_devices: int) -> ShardedCOO:
    """BCOH static banding: equal-nnz row bands, zero-padded to uniform
    shard shapes (host-side). ``num_devices > m`` yields empty bands;
    ``nnz == 0`` falls back to an even row split."""
    _check_devices(num_devices)
    m, n = coo.shape
    rows, cols, vals = _sorted_triplets(coo)
    row_ptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    if rows.size:
        bands = balanced_row_bands(row_ptr, num_devices)
    else:
        bands = ((np.arange(num_devices + 1, dtype=np.int64) * m)
                 // num_devices).astype(np.int32)
    nnz_start = row_ptr[bands]
    nnz_pad = max(int(np.diff(nnz_start).max()) if num_devices else 1, 1)
    rows_per = max(int(np.diff(bands).max()) if m else 1, 1)
    R = np.zeros((num_devices, nnz_pad), np.int32)
    C = np.zeros((num_devices, nnz_pad), np.int32)
    V = np.zeros((num_devices, nnz_pad), vals.dtype)
    for p in range(num_devices):
        a, b = int(nnz_start[p]), int(nnz_start[p + 1])
        R[p, :b - a] = rows[a:b] - bands[p]
        C[p, :b - a] = cols[a:b]
        V[p, :b - a] = vals[a:b]
    return _stack(R, C, V, bands[:-1], coo, rows_per)


def partition_nnz(coo: COO, num_devices: int) -> ShardedCOO:
    """Merge-style equal-nnz spans (rows may straddle shards). Padded
    entries target local row 0 with value 0."""
    _check_devices(num_devices)
    rows, cols, vals = _sorted_triplets(coo)
    nnz = rows.size
    bounds = (np.arange(num_devices + 1, dtype=np.int64) * nnz
              ) // num_devices
    nnz_pad = max(int(np.diff(bounds).max()), 1)
    R = np.zeros((num_devices, nnz_pad), np.int32)
    C = np.zeros((num_devices, nnz_pad), np.int32)
    V = np.zeros((num_devices, nnz_pad), vals.dtype)
    offs = np.zeros(num_devices, np.int64)
    for p in range(num_devices):
        a, b = int(bounds[p]), int(bounds[p + 1])
        if b > a:
            offs[p] = rows[a]
            R[p, :b - a] = rows[a:b] - rows[a]
            C[p, :b - a] = cols[a:b]
            V[p, :b - a] = vals[a:b]
    span_rows = max(int((R.max(axis=1) + 1).max()) if nnz else 1, 1)
    return _stack(R, C, V, offs, coo, span_rows)


def _as_2d(x: torch.Tensor):
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim != 2:
        raise ValueError(f"x must be [n] or [n, k], got shape "
                         f"{tuple(x.shape)}")
    return x, False


def _data_devices(sharded: ShardedCOO, mesh, axis: str):
    ndev = int(sharded.rows.shape[0])
    if ndev != mesh.shape[axis]:
        raise ValueError(f"matrix is partitioned over {ndev} devices but "
                         f"mesh axis {axis!r} has {mesh.shape[axis]}")
    i = list(mesh.axis_names).index(axis)
    return list(np.moveaxis(mesh.devices, i, 0).reshape(ndev, -1)[:, 0])


def _contrib(sharded: ShardedCOO, p: int, x2: torch.Tensor, dev):
    vals = sharded.vals[p].to(dev)
    xd = x2.to(dev)
    dtype = torch.promote_types(vals.dtype, xd.dtype)
    return (vals.to(dtype)[:, None] * xd.to(dtype)[sharded.cols[p].to(
        dev).long()]), sharded.rows[p].to(dev).long()


def spmv_row_distributed(sharded: ShardedCOO, x: torch.Tensor, mesh,
                         axis: str = "data") -> torch.Tensor:
    """``Y = A @ X`` with BCOH row banding: X replicated, Y shard-local
    (band ``p`` writes global rows ``[row_offset[p], row_offset[p+1])``)."""
    m, _ = sharded.shape
    devs = _data_devices(sharded, mesh, axis)
    x2, squeeze = _as_2d(x)
    rp = sharded.rows_per_shard
    offs = sharded.row_offset.tolist() + [m]
    pieces = []
    for p, dev in enumerate(devs):
        contrib, rows = _contrib(sharded, p, x2, dev)
        y_loc = torch.zeros((rp, x2.shape[1]), dtype=contrib.dtype,
                            device=dev).index_add_(0, rows, contrib)
        pieces.append(y_loc[:offs[p + 1] - offs[p]].to(x2.device))
    y = torch.cat(pieces, dim=0)
    return y[:, 0] if squeeze else y


def spmv_merge_distributed(sharded: ShardedCOO, x: torch.Tensor, mesh,
                           axis: str = "data") -> torch.Tensor:
    """``Y = A @ X`` with merge spans: each shard scatters into the global
    rows, the partials are summed on X's device in shard order."""
    m, _ = sharded.shape
    devs = _data_devices(sharded, mesh, axis)
    x2, squeeze = _as_2d(x)
    offs = sharded.row_offset.tolist()
    y = None
    for p, dev in enumerate(devs):
        contrib, rows = _contrib(sharded, p, x2, dev)
        part = torch.zeros((m, x2.shape[1]), dtype=contrib.dtype,
                           device=dev).index_add_(0, rows + offs[p], contrib)
        y = part.to(x2.device) if y is None else y + part.to(x2.device)
    return y[:, 0] if squeeze else y


__all__ = ["ShardedCOO", "partition_rows", "partition_nnz",
           "spmv_row_distributed", "spmv_merge_distributed"]
