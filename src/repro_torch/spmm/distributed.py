"""Multi-device multi-RHS SpMM over a device mesh — the port of
``repro.spmm.distributed``: the paper's two winning parallel schedules
(BCOH row banding §3.2, merge-path equal-nnz spans §3.3) over the SELL-C-σ
slice stream.

* ``partition_sellcs_rows`` + ``spmm_row_distributed`` — contiguous slice
  bands balanced by width-row count, X replicated per shard, Y written
  shard-local in slot space: no sum across shards.
* ``partition_sellcs_nnz`` + ``spmm_merge_distributed`` — equal spans of
  width-rows regardless of slice boundaries (a dense row's slice splits),
  every shard writes a partial over the whole slot space and the partials
  are summed (the reference's ``psum``). ``num_chunks > 1`` splits the slot
  space into spans of consecutive slices, each re-dealt equally over the
  shards and summed as soon as its kernels are enqueued.

A mesh with a ``model`` axis also splits the X/Y columns: model shard
``j`` owns columns ``[j*kc, (j+1)*kc)``, ``kc = ceil(k / P_model)``; the
split is slicing of X and concatenation of Y. ``compact_x=True`` relabels
each shard's ``cols`` into its touched-column set (``col_map``); the
multiply then gathers only those X rows, up front (``gather="upfront"``),
per chunk span (``"overlap"``), or inside the kernel (``"fused"``: K8). All
gather modes give bitwise-equal answers.

The partitioners are host numpy, and their stacked ``[P, Wp, C]`` arrays
equal the reference's. The CUDA kernels take a slice pointer where the
reference's Pallas kernels take per-width-row slice ids, so each
partition also records, per shard, the slice pointer of its REAL prefix
(``row_counts`` width-rows; the padding tail is never handed to a kernel)
and, for the transpose kernel K3, that pointer less the depth at which the
shard's first width-row sits in its slice (a merge span may start
mid-slice). ``_Shard`` holds each shard's real-prefix views, placed on its
mesh device at partition time (``devices=``).

The mesh body is one controller looping over the shards: shard ``p``'s
kernels launch on its mesh device, the sums move every partial to the
output device (X's) and add them in shard order. The same code serves
distinct cards and a mesh that names one device many times.

Phase tracing (``repro_torch.obs``): ``spmm/gather_x`` (and
``spmm/gather_x/span<i>`` under ``gather="overlap"``), ``spmm/mesh``,
``spmm/kernel``, ``spmm/psum`` and ``spmm/fixup``, each synchronised on
exit when a registry is installed (``maybe_block``), as the batcher's.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import _check_devices
from repro_torch.core.mergepath import balanced_row_bands
from repro_torch.obs import maybe_block, span
from .kernels import (sellcs_slots, sellcs_slots_plain, sellcs_slots_t,
                      sellcs_slots_t_plain)
from .reference import (_as_2d, sellcs_slot_x, sellcs_slots_ref,
                        sellcs_slots_t_ref)
from .sellcs import SellCS

# the reference pads each col_map row to the Pallas lane width; kept so the
# maps equal the reference's
LANE = 128

GATHER_MODES = ("upfront", "overlap", "fused")


class _Shard(NamedTuple):
    """One shard's real width-row prefix as its kernels take it, on its
    mesh device (views of the stacked arrays when that is their device)."""
    data: torch.Tensor           # f32[w, C]
    cols: torch.Tensor           # int32[w, C]
    slice_ptr: torch.Tensor      # int32[num_slices + 1] — K1/K8
    t_ids: torch.Tensor          # int32[w] — slice ids inside K3's window
    t_ptr: torch.Tensor          # int32[t_slices + 1] — K1/K8/K3 depth base
    t_row_len: torch.Tensor      # int32[t_slices * C] — their row_len window
    col_map: Optional[torch.Tensor]    # int32[Ntc] (compact_x only)
    num_slices: int              # K1 slot-space height in slices
    t_first: int                 # first global slice of K3's window
    n_touched: int = 0           # real prefix of col_map
    sub: Optional[torch.Tensor] = None       # int32[Nsub] (overlap feed)
    sub_map: Optional[torch.Tensor] = None   # int32[Nsub]

    @property
    def width_rows(self) -> int:
        return int(self.data.shape[0])


class ShardedSellCS(NamedTuple):
    """Per-shard SELL-C-σ width-row blocks, stacked on a leading shard
    axis, as the reference's; the port-only fields after ``diag`` are what
    the CUDA kernels take instead of per-width-row slice ids."""
    data: torch.Tensor           # f32[P, Wp, C] — zero-padded width-rows
    cols: torch.Tensor           # int32[P, Wp, C]
    slice_of: torch.Tensor       # int32[P, Wp] — LOCAL ("row") or GLOBAL
                                 #   ("merge") slice ids
    slice_offset: torch.Tensor   # int32[P] — first global slice ("row")
    row_perm: torch.Tensor       # int32[S*C] — global σ-sort permutation
    shape: Tuple[int, int]
    chunk: int                   # C
    num_slices: int              # S — global slice count
    slices_per_shard: int        # local slot-space height ("row"; S merge)
    nnz: int
    schedule: str                # "row" | "merge"
    chunk_plan: Optional[Tuple] = None
                                 # (num_chunks, spans, plan col_map, plan
                                 #   n_touched), as the reference's
    row_counts: Optional[torch.Tensor] = None   # int32[P] real width-rows
    col_map: Optional[torch.Tensor] = None      # int32[P, Ntc]
    n_touched: Optional[torch.Tensor] = None    # int32[P]
    structure: str = "general"
    diag: Optional[torch.Tensor] = None         # f32[m] (symmetric)
    slice_ptr: Optional[torch.Tensor] = None
                                 # int32[P, Sp+1] — K1/K8 slice pointer of
                                 #   each shard's real prefix over its slot
                                 #   space (Sp local slices "row", S "merge")
    depth_ptr: Optional[torch.Tensor] = None
                                 # int32[P, S+1] ("merge") — K3's: slice_ptr
                                 #   less the depth of each shard's first
                                 #   width-row in its slice
    row_len: Optional[torch.Tensor] = None      # int32[S*C] — K3 skips
                                 #   padding entries by it
    shards: Tuple[_Shard, ...] = ()

    def storage_bytes(self) -> int:
        """Every stacked member array (the reference's, the compact maps,
        a baked chunk plan, and the port's slice pointers and slot
        lengths). Shard copies placed on other devices than the stacked
        arrays' come on top."""
        def nb(t):
            return 0 if t is None else t.numel() * t.element_size()
        total = sum(nb(t) for t in (
            self.data, self.cols, self.slice_of, self.slice_offset,
            self.row_perm, self.row_counts, self.col_map, self.n_touched,
            self.diag, self.slice_ptr, self.depth_ptr, self.row_len))
        if self.chunk_plan is not None:
            for sp in self.chunk_plan[1]:
                total += sum(nb(t) for t in (
                    sp.data, sp.cols, sp.slice_of, sp.sub, sp.col_map,
                    sp.n_touched, sp.slice_ptr, sp.depth_ptr, sp.local_of))
            total += nb(self.chunk_plan[2]) + nb(self.chunk_plan[3])
        return int(total)


class _ChunkSpan(NamedTuple):
    """One pipelined span of the slice stream, re-dealt equally over the
    shards (the reference's fields first; see ``repro.spmm.distributed``)."""
    slice_start: int
    num_slices: int
    data: torch.Tensor           # [P, Wc, C]
    cols: torch.Tensor           # int32[P, Wc, C]
    slice_of: torch.Tensor       # int32[P, Wc] — GLOBAL slice ids
    sub: Optional[torch.Tensor] = None        # int32[P, Nsub]
    col_map: Optional[torch.Tensor] = None    # int32[P, Nsub]
    n_touched: Optional[torch.Tensor] = None  # int32[P]
    slice_ptr: Optional[torch.Tensor] = None  # int32[P, ns+1]
    depth_ptr: Optional[torch.Tensor] = None  # int32[P, ns+1]
    local_of: Optional[torch.Tensor] = None   # int32[P, Wc] — ids - start
    shards: Tuple[_Shard, ...] = ()


class _ChunkPlan(NamedTuple):
    spans: Tuple[_ChunkSpan, ...]
    col_map: Optional[torch.Tensor]     # int32[P, Ntc'] (compact only)
    n_touched: Optional[torch.Tensor]   # int32[P]


# --------------------------------------------------------------------------
# storage: the deals (host numpy, equal to the reference's arrays)
# --------------------------------------------------------------------------
def _compact_columns(Cc: np.ndarray, counts: np.ndarray):
    """Per-shard touched-column maps over the dealt ``cols`` blocks:
    returns ``(relabeled Cc, col_map int64[P, Ntc], n_touched int64[P])``.
    Lane padding inside a real width-row carries col 0, so col 0 joins the
    touched set of every nonempty shard; padding width-rows keep col 0."""
    P = Cc.shape[0]
    touched = [np.unique(Cc[p, :int(counts[p])]) if int(counts[p])
               else np.zeros(0, np.int64) for p in range(P)]
    col_map, n_touched = _pack_maps(touched)
    for p, t in enumerate(touched):
        ln = int(counts[p])
        if ln:
            Cc[p, :ln] = np.searchsorted(t, Cc[p, :ln])
    return Cc, col_map, n_touched


def _pack_maps(touched):
    """Stack sorted touched sets into ``(col_map int64[P, Ntc], n_touched
    int64[P])``, Ntc >= 1 rounded up to :data:`LANE`; padding entries point
    at row 0."""
    n_touched = np.array([t.size for t in touched], np.int64)
    Ntc = max(int(n_touched.max()) if len(touched) else 0, 1)
    Ntc = -(-Ntc // LANE) * LANE
    col_map = np.zeros((len(touched), Ntc), np.int64)
    for p, t in enumerate(touched):
        col_map[p, :t.size] = t
        assert not col_map[p, t.size:].any(), \
            "col_map padding must point at row 0"
    return col_map, n_touched


def _deal_slice_bands(data: np.ndarray, cols: np.ndarray,
                      slice_of: np.ndarray, slice_ptr: np.ndarray,
                      num_devices: int, C: int):
    """The BCOH deal: contiguous slice bands balanced by width-row count,
    slice ids rebased per band. Returns ``(D, Cc, So, bounds, Sp,
    counts)``."""
    bounds = balanced_row_bands(slice_ptr, num_devices).astype(np.int64)
    w_start = slice_ptr[bounds]
    Wp = max(int(np.diff(w_start).max()) if num_devices else 1, 1)
    Sp = max(int(np.diff(bounds).max()), 1)
    D = np.zeros((num_devices, Wp, C), data.dtype if data.size else
                 np.float32)
    Cc = np.zeros((num_devices, Wp, C), np.int32)
    So = np.zeros((num_devices, Wp), np.int32)
    for p in range(num_devices):
        a, b = int(w_start[p]), int(w_start[p + 1])
        ln = b - a
        if ln:
            D[p, :ln] = data[a:b]
            Cc[p, :ln] = cols[a:b]
            So[p, :ln] = (slice_of[a:b] - bounds[p]).astype(np.int32)
    return D, Cc, So, bounds, Sp, np.diff(w_start)


def _deal_width_rows(data: np.ndarray, cols: np.ndarray,
                     slice_of: np.ndarray, num_devices: int, C: int):
    """The merge deal: equal spans of width-rows, slice ids global.
    Returns ``(D, Cc, So, counts)``."""
    W = data.shape[0]
    bounds = (np.arange(num_devices + 1, dtype=np.int64) * W) // num_devices
    Wp = max(int(np.diff(bounds).max()), 1)
    D = np.zeros((num_devices, Wp, C), data.dtype if data.size else
                 np.float32)
    Cc = np.zeros((num_devices, Wp, C), np.int32)
    So = np.zeros((num_devices, Wp), np.int32)
    for p in range(num_devices):
        a, b = int(bounds[p]), int(bounds[p + 1])
        ln = b - a
        if ln:
            D[p, :ln] = data[a:b]
            Cc[p, :ln] = cols[a:b]
            So[p, :ln] = slice_of[a:b].astype(np.int32)
    return D, Cc, So, np.diff(bounds)


def _prefix_ptrs(So: np.ndarray, counts, starts, shift, gbase, ns: int,
                 g_ptr: np.ndarray):
    """Per shard, over its real prefix ``So[p, :counts[p]]`` (ids less
    ``shift[p]`` index ``ns`` slices that start at global slice
    ``gbase[p]``): K1's slice pointer and K3's depth base, both
    int32[P, ns+1]. ``starts[p]`` is the prefix's first position in the
    global width-row stream whose slice pointer is ``g_ptr``. A band of
    whole slices (the row deal) has a depth base equal to its pointer."""
    P = So.shape[0]
    ptr = np.zeros((P, ns + 1), np.int64)
    dptr = np.zeros((P, ns + 1), np.int64)
    for p in range(P):
        ln = int(counts[p])
        if not ln:
            continue
        ids = So[p, :ln].astype(np.int64) - int(shift[p])
        if ids[0] < 0 or ids[-1] >= ns or (np.diff(ids) < 0).any():
            raise AssertionError("a shard's real prefix must hold "
                                 "nondecreasing slice ids inside its span")
        ptr[p, 1:] = np.cumsum(np.bincount(ids, minlength=ns))
        dptr[p] = ptr[p]
        s0 = int(ids[0])
        dptr[p, s0] -= int(starts[p]) - int(g_ptr[int(gbase[p]) + s0])
    return ptr.astype(np.int32), dptr.astype(np.int32)


def _stream_ptr(g_so: np.ndarray, S: int) -> np.ndarray:
    widths = (np.bincount(g_so, minlength=S) if g_so.size
              else np.zeros(S, np.int64))
    ptr = np.zeros(S + 1, np.int64)
    np.cumsum(widths, out=ptr[1:])
    return ptr


def _starts(counts) -> np.ndarray:
    c = np.asarray(counts, np.int64)
    return np.concatenate([[0], np.cumsum(c)[:-1]]) if c.size else c


def _devices_of(devices, P: int, home: torch.device):
    if devices is None:
        return [home] * P
    devs = [torch.device(d) for d in devices]
    if len(devs) != P:
        raise ValueError(f"devices= names {len(devs)} devices for {P} "
                         "shards")
    return devs


def _place(data, cols, ids, ptr, tptr, row_len, col_map, n_touched,
           counts, t_first, t_slices, C: int, devices, sub=None,
           sub_map=None) -> Tuple[_Shard, ...]:
    """Per-shard real-prefix views of stacked tensors, moved to each
    shard's device (a view when it is already there)."""
    out = []
    nt = (n_touched.tolist() if n_touched is not None
          else [0] * len(devices))
    for p, dev in enumerate(devices):
        ln, tf, ts = int(counts[p]), int(t_first[p]), int(t_slices[p])
        out.append(_Shard(
            data[p, :ln].to(dev), cols[p, :ln].to(dev), ptr[p].to(dev),
            ids[p, :ln].to(dev), tptr[p, :ts + 1].to(dev),
            row_len[tf * C:(tf + ts) * C].to(dev),
            None if col_map is None else col_map[p].to(dev),
            int(ptr.shape[1]) - 1, tf, int(nt[p]),
            None if sub is None else sub[p].to(dev),
            None if sub_map is None else sub_map[p].to(dev)))
    return tuple(out)


def _t(a: np.ndarray, dev, dtype=None) -> torch.Tensor:
    a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
    return torch.from_numpy(a).to(dev)


def _row_sharded(D, Cc, So, bounds, Sp, counts, g_ptr, compact, *, row_perm,
                 row_len, diag, shape, C, S, nnz, structure, home,
                 devices) -> ShardedSellCS:
    """The "row" partition from a band deal (shared by the partitioner
    and the device-loss re-deal)."""
    P = D.shape[0]
    col_map = n_touched = None
    if compact:
        Cc, cm, nt = _compact_columns(Cc.astype(np.int64), counts)
        col_map, n_touched = _t(cm, home, np.int32), _t(nt, home, np.int32)
    ptr, dptr = _prefix_ptrs(So, counts, _starts(counts), np.zeros(P),
                             bounds[:-1], Sp, g_ptr)
    assert np.array_equal(ptr, dptr), "a row band starts mid-slice"
    ptr_t = _t(ptr, home)
    data_t, cols_t = _t(D, home), _t(Cc, home, np.int32)
    so_t = _t(So, home, np.int32)
    shards = _place(data_t, cols_t, so_t, ptr_t, ptr_t, row_len, col_map,
                    n_touched, counts, bounds[:-1], np.diff(bounds), C,
                    _devices_of(devices, P, home))
    return ShardedSellCS(
        data_t, cols_t, so_t, _t(bounds[:-1], home, np.int32), row_perm,
        shape, C, S, Sp, nnz, "row", row_counts=_t(counts, home, np.int32),
        col_map=col_map, n_touched=n_touched, structure=structure,
        diag=diag, slice_ptr=ptr_t, row_len=row_len, shards=shards)


def _merge_sharded(D, Cc, So, counts, g_ptr, nc: int, compact, *,
                   row_perm, row_len, diag, shape, C, S, nnz, structure,
                   home, devices) -> ShardedSellCS:
    """The "merge" partition from a width-row deal, with its chunk plan
    baked when ``nc > 1`` (shared by the partitioner and the re-deal)."""
    P = D.shape[0]
    devs = _devices_of(devices, P, home)
    zero = np.zeros(P, np.int64)
    ptr, dptr = _prefix_ptrs(So, counts, _starts(counts), zero, zero, S,
                             g_ptr)
    data_t = _t(D, home)
    so_t = _t(So, home, np.int32)
    ptr_t, dptr_t = _t(ptr, home), _t(dptr, home)
    sharded = ShardedSellCS(
        data_t, _t(Cc, home, np.int32), so_t,
        torch.zeros(P, dtype=torch.int32, device=home), row_perm, shape, C,
        S, S, nnz, "merge", row_counts=_t(counts, home, np.int32),
        structure=structure, diag=diag, slice_ptr=ptr_t, depth_ptr=dptr_t,
        row_len=row_len)
    plan = None
    if nc > 1:
        # baked before the base relabel: the plan's own map covers the
        # re-dealt ownership and needs global column ids
        plan = _chunk_substreams(sharded, nc, compact=compact, devices=devs)
    col_map = n_touched = None
    if compact:
        Cc, cm, nt = _compact_columns(Cc.astype(np.int64), counts)
        col_map, n_touched = _t(cm, home, np.int32), _t(nt, home, np.int32)
        sharded = sharded._replace(cols=_t(Cc, home, np.int32),
                                   col_map=col_map, n_touched=n_touched)
    shards = _place(data_t, sharded.cols, so_t, ptr_t, dptr_t, row_len,
                    col_map, n_touched, counts, zero, np.full(P, S), C,
                    devs)
    sharded = sharded._replace(shards=shards)
    if plan is not None:
        sharded = sharded._replace(chunk_plan=(nc, plan.spans, plan.col_map,
                                               plan.n_touched))
    return sharded


def _host(sc: SellCS):
    return (sc.data.cpu().numpy(), sc.cols.cpu().numpy(),
            sc.slice_of.cpu().numpy().astype(np.int64),
            sc.slice_ptr.cpu().numpy().astype(np.int64))


def partition_sellcs_rows(sc: SellCS, num_devices: int, *,
                          compact_x: bool = False,
                          devices: Optional[Sequence] = None
                          ) -> ShardedSellCS:
    """BCOH banding over the slice stream: contiguous slice ranges balanced
    by width-row count. Host-side, convert time. Slices own disjoint row
    slots, so Y needs no sum across shards. ``compact_x=True`` adds each
    shard's touched-column map and relabels ``cols`` into it.
    ``devices`` (one per shard; default the stream's device) is where
    each shard's real prefix lives for the multiply."""
    _check_devices(num_devices)
    data, cols, so, ptr = _host(sc)
    D, Cc, So, bounds, Sp, counts = _deal_slice_bands(
        data, cols, so, ptr, num_devices, sc.chunk)
    return _row_sharded(D, Cc, So, bounds, Sp, counts, ptr, compact_x,
                        row_perm=sc.row_perm, row_len=sc.row_len,
                        diag=sc.diag, shape=tuple(sc.shape), C=sc.chunk,
                        S=sc.num_slices, nnz=sc.nnz,
                        structure=sc.structure, home=sc.device,
                        devices=devices)


def partition_sellcs_nnz(sc: SellCS, num_devices: int, *,
                         num_chunks: int = 1, compact_x: bool = False,
                         devices: Optional[Sequence] = None
                         ) -> ShardedSellCS:
    """Merge-style equal spans over the width-row stream (slices, and with
    them dense rows, may straddle shards); ``slice_of`` stays global and
    the partials are summed. ``num_chunks > 1`` bakes the pipelined span
    plan here; ``compact_x`` relabels ``cols`` through each shard's
    touched-column map (the chunk plan carries its own)."""
    _check_devices(num_devices)
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    data, cols, so, ptr = _host(sc)
    D, Cc, So, counts = _deal_width_rows(data, cols, so, num_devices,
                                         sc.chunk)
    return _merge_sharded(D, Cc, So, counts, ptr, int(num_chunks),
                          compact_x, row_perm=sc.row_perm,
                          row_len=sc.row_len, diag=sc.diag,
                          shape=tuple(sc.shape), C=sc.chunk,
                          S=sc.num_slices, nnz=sc.nnz,
                          structure=sc.structure, home=sc.device,
                          devices=devices)


def _shard_devices(sharded: ShardedSellCS):
    return [sh.data.device for sh in sharded.shards] or None


def rechunk_sellcs(sharded: ShardedSellCS,
                   num_chunks: int) -> ShardedSellCS:
    """Re-bake ONLY the pipelined span plan of a "merge" partition; the
    dealt blocks, the σ permutation and the compact maps are reused.
    ``num_chunks = 1`` drops the plan; a matching plan is returned
    as-is."""
    if sharded.schedule != "merge":
        raise ValueError("rechunk_sellcs needs a 'merge' partition, got "
                         f"{sharded.schedule!r}")
    nc = int(num_chunks)
    if nc < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    if nc == 1:
        return sharded._replace(chunk_plan=None)
    if sharded.chunk_plan is not None and sharded.chunk_plan[0] == nc:
        return sharded
    plan = _chunk_substreams(sharded, nc, devices=_shard_devices(sharded))
    return sharded._replace(chunk_plan=(nc, plan.spans, plan.col_map,
                                        plan.n_touched))


def redeal_sellcs(sharded: ShardedSellCS, num_devices: int, *,
                  num_chunks: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> ShardedSellCS:
    """Device-loss re-deal: rebuild a partition over a new device count
    from its shards alone (no σ-sort, no conversion); the result equals
    what the partitioners would build from the original stream.
    ``compact_x`` is inherited; ``num_chunks`` defaults to the input's
    baked depth ("merge" only)."""
    _check_devices(num_devices)
    compact = sharded.col_map is not None
    g_data, g_cols, g_so = _global_stream(sharded)
    C, S = sharded.chunk, sharded.num_slices
    g_ptr = _stream_ptr(g_so, S)
    home = sharded.data.device
    meta = dict(row_perm=sharded.row_perm, row_len=sharded.row_len,
                diag=sharded.diag, shape=sharded.shape, C=C, S=S,
                nnz=sharded.nnz, structure=sharded.structure, home=home,
                devices=devices)
    if sharded.schedule == "row":
        D, Cc, So, bounds, Sp, counts = _deal_slice_bands(
            g_data, g_cols, g_so, g_ptr, num_devices, C)
        return _row_sharded(D, Cc, So, bounds, Sp, counts, g_ptr, compact,
                            **meta)
    nc = (int(num_chunks) if num_chunks is not None
          else (sharded.chunk_plan[0] if sharded.chunk_plan is not None
                else 1))
    if nc < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    D, Cc, So, counts = _deal_width_rows(g_data, g_cols, g_so,
                                         num_devices, C)
    return _merge_sharded(D, Cc, So, counts, g_ptr, nc, compact, **meta)


def _global_stream(sharded: ShardedSellCS):
    """Flatten a partition back into the global σ-sorted width-row stream
    (global column and slice ids; real rows from ``row_counts``). Returns
    ``(g_data [W', C], g_cols [W', C], g_so [W'])``."""
    data = sharded.data.cpu().numpy()
    cols = sharded.cols.cpu().numpy()
    if sharded.col_map is not None:
        cm = sharded.col_map.cpu().numpy().astype(np.int64)
        cols = cm[np.arange(cm.shape[0])[:, None, None],
                  cols.astype(np.int64)]
    so = sharded.slice_of.cpu().numpy().astype(np.int64)
    if sharded.schedule == "row":
        so = so + sharded.slice_offset.cpu().numpy().astype(
            np.int64)[:, None]
    if sharded.row_counts is None:
        raise ValueError("sharded matrix carries no row_counts; rebuild it "
                         "with partition_sellcs_nnz")
    counts = sharded.row_counts.cpu().numpy().astype(np.int64)
    real = (np.arange(data.shape[1], dtype=np.int64)[None]
            < counts[:, None])
    return data[real], cols[real], so[real]


def _chunk_substreams(sharded: ShardedSellCS, num_chunks: int, *,
                      compact: Optional[bool] = None,
                      devices=None) -> _ChunkPlan:
    """Split the slice stream into ``num_chunks`` width-balanced slice
    spans and deal EACH span's width-rows equally over the shards. A
    ``compact`` plan carries one touched-column map per shard over its
    re-dealt rows of every span, and per span the touched split that the
    overlapped gather reads (``sub``, ``col_map``, ``n_touched``)."""
    if compact is None:
        compact = sharded.col_map is not None
    g_data, g_cols, g_so = _global_stream(sharded)
    Pdev = sharded.data.shape[0]
    C, S = sharded.chunk, sharded.num_slices
    home = sharded.data.device
    devs = _devices_of(devices, Pdev, home)
    g_ptr = _stream_ptr(g_so, S)
    bounds = balanced_row_bands(g_ptr, int(num_chunks)).astype(np.int64)
    raw = []
    for i in range(int(num_chunks)):
        s0, s1 = int(bounds[i]), int(bounds[i + 1])
        if s1 <= s0:
            continue                                 # empty band (nc > S)
        a, b = int(g_ptr[s0]), int(g_ptr[s1])
        Wi = b - a
        Wc = max(-(-Wi // Pdev), 1)
        D = np.zeros((Pdev, Wc, C), g_data.dtype)
        Cc = np.zeros((Pdev, Wc, C), np.int64)
        So = np.full((Pdev, Wc), s0, np.int32)       # padding rebases to 0
        db = (np.arange(Pdev + 1, dtype=np.int64) * Wi) // Pdev
        for p in range(Pdev):
            ln = int(db[p + 1] - db[p])
            if ln:
                D[p, :ln] = g_data[a + db[p]:a + db[p + 1]]
                Cc[p, :ln] = g_cols[a + db[p]:a + db[p + 1]]
                So[p, :ln] = g_so[a + db[p]:a + db[p + 1]].astype(np.int32)
        raw.append((s0, s1 - s0, D, Cc, So, np.diff(db), a + db[:-1]))
    plan_map = plan_nt = None
    span_maps = [(None, None, None)] * len(raw)
    if compact:
        touched = []
        for p in range(Pdev):
            vals = [Cc[p, :int(lens[p])].ravel()
                    for _, _, _, Cc, _, lens, _ in raw if int(lens[p])]
            touched.append(np.unique(np.concatenate(vals)) if vals
                           else np.zeros(0, np.int64))
        cm, nt = _pack_maps(touched)
        for _, _, _, Cc, _, lens, _ in raw:
            for p in range(Pdev):
                ln = int(lens[p])
                if ln:
                    Cc[p, :ln] = np.searchsorted(touched[p], Cc[p, :ln])
        plan_map, plan_nt = _t(cm, home, np.int32), _t(nt, home, np.int32)
        span_maps = []
        for _, _, _, Cc, _, lens, _ in raw:
            subs = [np.unique(Cc[p, :int(lens[p])].ravel())
                    if int(lens[p]) else np.zeros(0, np.int64)
                    for p in range(Pdev)]
            ns_ = np.array([s.size for s in subs], np.int64)
            Wsub = max(int(ns_.max()), 1)
            sub = np.zeros((Pdev, Wsub), np.int64)
            gcm = np.zeros((Pdev, Wsub), np.int64)
            for p, s in enumerate(subs):
                sub[p, :s.size] = s
                gcm[p, :s.size] = cm[p][s]
                gcm[p, s.size:] = cm[p, 0]
            span_maps.append((_t(sub, home, np.int32),
                              _t(gcm, home, np.int32),
                              _t(ns_, home, np.int32)))
    spans = []
    for (s0, ns, D, Cc, So, lens, starts), (sub, gcm, snt) in zip(raw,
                                                                span_maps):
        shift = np.full(Pdev, s0, np.int64)
        ptr, dptr = _prefix_ptrs(So, lens, starts, shift, shift, ns, g_ptr)
        data_t, cols_t = _t(D, home), _t(Cc, home, np.int32)
        so_t = _t(So, home, np.int32)
        ptr_t, dptr_t = _t(ptr, home), _t(dptr, home)
        local_t = so_t - s0
        shards = _place(data_t, cols_t, local_t, ptr_t, dptr_t,
                        sharded.row_len, plan_map, plan_nt, lens, shift,
                        np.full(Pdev, ns), C, devs, sub=sub, sub_map=gcm)
        spans.append(_ChunkSpan(s0, ns, data_t, cols_t, so_t, sub, gcm, snt,
                                ptr_t, dptr_t, local_t, shards))
    return _ChunkPlan(tuple(spans), plan_map, plan_nt)


def _resolve_gather(gather: Optional[str], compact: bool) -> str:
    """Validate the gather knob; ``None`` is the up-front gather. The
    overlapped and fused modes need a compact partition."""
    if gather is None:
        return "upfront"
    if gather not in GATHER_MODES:
        raise ValueError(
            f"gather must be one of {GATHER_MODES} or None, got {gather!r}")
    if gather != "upfront" and not compact:
        raise ValueError(
            f"gather={gather!r} needs a compact_x partition — a "
            "replicated-X stream has no X gather to hide; repartition "
            "with compact_x=True")
    return gather


# --------------------------------------------------------------------------
# the multiplies
# --------------------------------------------------------------------------
class _Ctx(NamedTuple):
    x2: torch.Tensor             # X as [rows, k] on the output device
    squeeze: bool
    k: int
    grid: np.ndarray             # object [P_data, P_model] of devices
    col_ranges: Tuple[Tuple[int, int], ...]   # per model shard, nonempty
    impl: str                    # "ref" | "plain" | "kernel"
    compact: bool
    out: torch.device


def _device_grid(mesh, axis: str, maxis: Optional[str]) -> np.ndarray:
    """Devices as ``[P_data, P_model]`` (other axes must have length 1)."""
    names = list(mesh.axis_names)
    order = [names.index(axis)] + ([names.index(maxis)] if maxis else [])
    rest = [i for i in range(len(names)) if i not in order]
    if any(mesh.devices.shape[i] != 1 for i in rest):
        raise ValueError(f"mesh axes {[names[i] for i in rest]} are neither "
                         f"the data axis {axis!r} nor the model axis")
    arr = np.transpose(mesh.devices, order + rest)
    arr = arr.reshape(arr.shape[:len(order)])
    return arr if maxis else arr[:, None]


def _resolve_model_axis(mesh, axis: str, model_axis: Optional[str]):
    """(model axis name or None, P_model); ``None`` adopts a ``"model"``
    mesh axis when there is one."""
    if model_axis is None:
        model_axis = "model" if "model" in mesh.axis_names else None
    elif model_axis not in mesh.axis_names:
        raise ValueError(f"model_axis {model_axis!r} is not a mesh axis; "
                         f"mesh has {tuple(mesh.axis_names)}")
    if model_axis == axis:
        raise ValueError(f"model_axis {model_axis!r} collides with the "
                         f"data axis {axis!r}")
    return model_axis, (int(mesh.shape[model_axis]) if model_axis else 1)


def _prep(sharded: ShardedSellCS, x: torch.Tensor, mesh, axis: str,
          impl: str, expect: str, model_axis: Optional[str],
          compact_x: Optional[bool], op: str) -> _Ctx:
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    if sharded.schedule != expect:
        raise ValueError(
            f"sharded matrix was partitioned for the {sharded.schedule!r} "
            f"schedule; build it with partition_sellcs_"
            f"{'rows' if expect == 'row' else 'nnz'} instead")
    ndev = int(sharded.data.shape[0])
    if ndev != mesh.shape[axis]:
        raise ValueError(f"matrix is partitioned over {ndev} devices but "
                         f"mesh axis {axis!r} has {mesh.shape[axis]}")
    compact = sharded.col_map is not None
    if compact_x is not None and compact_x != compact:
        raise ValueError(
            f"compact_x={compact_x} but the matrix was partitioned with "
            f"compact_x={compact}; repartition with partition_sellcs_"
            f"{'rows' if expect == 'row' else 'nnz'}(..., "
            f"compact_x={compact_x})")
    maxis, pm = _resolve_model_axis(mesh, axis, model_axis)
    grid = _device_grid(mesh, axis, maxis)
    if impl == "auto":
        impl = "kernel" if grid[0, 0].type == "cuda" else "ref"
    if impl not in ("ref", "plain", "kernel"):
        raise ValueError(f"impl must be auto|ref|plain|kernel, got "
                         f"{impl!r}")
    if impl == "kernel" and any(d.type != "cuda" for d in grid.flat):
        raise ValueError("impl='kernel' needs a mesh of CUDA devices; use "
                         "impl='plain' for the plain versions on the CPU")
    x2, squeeze = _as_2d(x)
    m, n = sharded.shape
    n_in = m if op == "T" else n
    if x2.shape[0] != n_in:
        raise ValueError(f"X rows {x2.shape[0]} != expected {n_in} "
                         f"(op={op!r}, matrix {m}x{n})")
    if impl != "ref":
        x2 = x2.to(torch.float32).contiguous()
    k = int(x2.shape[1])
    kc = -(-k // pm)
    ranges = tuple((j * kc, min(k, (j + 1) * kc)) for j in range(pm)
                   if j * kc < k)
    return _Ctx(x2, squeeze, k, grid, ranges, impl, compact, x2.device)


def _out_dtype(sharded: ShardedSellCS, ctx: _Ctx):
    if ctx.impl != "ref":
        return torch.float32
    return torch.promote_types(sharded.data.dtype, ctx.x2.dtype)


def _zeros(sharded, ctx, rows):
    y = torch.zeros((rows, ctx.k), dtype=_out_dtype(sharded, ctx),
                    device=ctx.out)
    return y[:, 0] if ctx.squeeze else y


def _slab(x: torch.Tensor, c0: int, c1: int, ncols: int) -> torch.Tensor:
    """Model shard's column slab of ``x`` (a copy only when it is a true
    sub-range)."""
    return x if (c0, c1) == (0, ncols) else x[:, c0:c1].contiguous()


def _gather_x(x: torch.Tensor, col_map: torch.Tensor) -> torch.Tensor:
    """The sparsity-aware X gather: the ``[Ntc, kc]`` slab of the rows a
    shard's relabeled ``cols`` name."""
    return x.index_select(0, col_map)


def _local_slots(sh: _Shard, x: torch.Tensor, *, impl: str, chunk: int,
                 col_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One shard's slot partial ``[num_slices*C, kc]``: K1, or K8 with
    ``col_map`` (``x`` the full X), or their plain versions, or the
    oracle. K1/K8 stop each lane at its row's end: the shard's window of
    ``row_len`` and its depth base (K3's ``t_row_len`` / ``t_ptr``; a
    merge span that starts mid-slice has a negative base)."""
    if impl == "ref":
        return sellcs_slots_ref(sh.data, sh.cols, sh.t_ids, x,
                                num_slices=sh.num_slices, chunk=chunk,
                                col_map=col_map)
    fn = sellcs_slots_plain if impl == "plain" else sellcs_slots
    return fn(sh.data, sh.cols, sh.slice_ptr, x, num_slices=sh.num_slices,
              chunk=chunk, col_map=col_map, row_len=sh.t_row_len,
              depth_ptr=sh.t_ptr)


def _local_slots_t(sh: _Shard, xs: torch.Tensor, *, n_out: int, impl: str,
                   chunk: int) -> torch.Tensor:
    """One shard's transpose partial ``[n_out, kc]`` (K3): ``xs`` is the
    slot-permuted X over the shard's window of slices."""
    if impl == "ref":
        return sellcs_slots_t_ref(sh.data, sh.cols, sh.t_ids, xs,
                                  n_out=n_out, chunk=chunk)
    fn = sellcs_slots_t_plain if impl == "plain" else sellcs_slots_t
    return fn(sh.data, sh.cols, sh.t_ids, sh.t_ptr, sh.t_row_len, xs,
              n_out=n_out, chunk=chunk)


def _psum(parts: List[torch.Tensor], out: torch.device) -> torch.Tensor:
    """The reference's psum: every partial moved to the output device and
    added in shard order."""
    with span("spmm/psum"):
        total = parts[0].to(out)
        for part in parts[1:]:
            total = total + part.to(out)
        return maybe_block(total)


def _kernel(fn, *args, **kw):
    with span("spmm/kernel"):
        return maybe_block(fn(*args, **kw))


def _feeds(shards, ctx: _Ctx, gmode: str):
    """What each (column block ``j``, shard ``p``) kernel reads, on the
    shard's device: X's column slab, or under an up-front compact gather
    the gathered ``[Ntc, kc]`` slab (built once per multiply, shared by
    every chunk span: the spans of a plan share its map)."""
    feeds = []
    for j, (c0, c1) in enumerate(ctx.col_ranges):
        x_j = _slab(ctx.x2, c0, c1, ctx.k)
        row = []
        for p, sh in enumerate(shards):
            x_d = x_j.to(ctx.grid[p, j])
            if ctx.compact and gmode == "upfront":
                with span("spmm/gather_x"):
                    x_d = maybe_block(_gather_x(x_d, sh.col_map))
            row.append(x_d)
        feeds.append(row)
    return feeds


def _normal_pass(shards, feeds, ctx: _Ctx, gmode: str, chunk: int,
                 label: str = "spmm/gather_x"):
    """One pass of K1/K8 over ``shards`` for every column block: returns
    ``parts[j][p]``, the partial of shard ``p`` for block ``j`` on its
    device (None for an empty shard). ``gather="overlap"`` builds this
    pass's piece of the slab from the shard's touched split just before
    its kernel; ``"fused"`` hands K8 the full X and the map."""
    parts = []
    for j in range(len(ctx.col_ranges)):
        row = []
        for p, sh in enumerate(shards):
            if sh.width_rows == 0:
                row.append(None)
                continue
            x_d, cmap = feeds[j][p], None
            if ctx.compact and gmode == "fused":
                cmap = sh.col_map
            elif ctx.compact and gmode == "overlap":
                with span(label):
                    # duplicate padding entries carry the same value
                    x_d = maybe_block(torch.zeros(
                        (sh.col_map.shape[0], x_d.shape[1]),
                        dtype=x_d.dtype, device=x_d.device).index_copy_(
                            0, sh.sub.long(), _gather_x(x_d, sh.sub_map)))
            row.append(_kernel(_local_slots, sh, x_d, impl=ctx.impl,
                               chunk=chunk, col_map=cmap))
        parts.append(row)
    return parts


def _unpermute(sharded: ShardedSellCS, y_slots: torch.Tensor, ctx: _Ctx
               ) -> torch.Tensor:
    """Undo the global σ-sort with one scatter (padding slots land on row
    m, dropped)."""
    m = sharded.shape[0]
    y = torch.zeros((m + 1, y_slots.shape[1]), dtype=y_slots.dtype,
                    device=ctx.out)
    y.index_add_(0, sharded.row_perm.to(ctx.out), y_slots)
    y = y[:m]
    return y[:, 0] if ctx.squeeze else y


def _cat_cols(blocks: List[torch.Tensor]) -> torch.Tensor:
    return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


def _scatter_touched(total: torch.Tensor, col_map: torch.Tensor,
                     n_touched: int, y: torch.Tensor) -> None:
    """``op='T'`` under ``compact_x``: a shard's output in its compacted
    index space scatter-adds through its touched-column map into the
    global output rows ``y`` (the map's padding past ``n_touched`` is
    dropped)."""
    if n_touched:
        y.index_add_(0, col_map[:n_touched].to(y.device),
                     total[:n_touched].to(y.device))


def _transpose(sharded: ShardedSellCS, ctx: _Ctx, passes) -> torch.Tensor:
    """``Y = A^T X`` over one or more shard passes (the base shards or the
    chunk spans): X enters slot-permuted, each shard adds into column
    space through K3; without ``compact_x`` each pass's partials are
    summed and the passes added, under it each shard's passes are added
    locally and scatter through its touched-column map."""
    m, n = sharded.shape
    C = sharded.chunk
    xs = sellcs_slot_x(sharded.row_perm.to(ctx.out), ctx.x2, m)
    shards0 = passes[0]
    n_eff = int(shards0[0].col_map.shape[0]) if ctx.compact else n
    dtype = _out_dtype(sharded, ctx)
    blocks = []
    with span("spmm/mesh"):
        for j, (c0, c1) in enumerate(ctx.col_ranges):
            xs_j = _slab(xs, c0, c1, ctx.k)
            total = None
            local = [None] * len(shards0)
            for shards in passes:
                parts = []
                for p, sh in enumerate(shards):
                    if sh.width_rows == 0:
                        continue
                    win = xs_j[sh.t_first * C:
                               (sh.t_first + sh.t_ptr.shape[0] - 1) * C]
                    y_p = _kernel(_local_slots_t, sh, win.to(ctx.grid[p, j]),
                                  n_out=n_eff, impl=ctx.impl, chunk=C)
                    if ctx.compact:
                        local[p] = y_p if local[p] is None else local[p] + y_p
                    else:
                        parts.append(y_p)
                if parts:
                    s = _psum(parts, ctx.out)
                    total = s if total is None else total + s
            if ctx.compact:
                with span("spmm/fixup"):
                    total = torch.zeros((n, c1 - c0), dtype=dtype,
                                        device=ctx.out)
                    for p, sh in enumerate(shards0):
                        if local[p] is not None:
                            _scatter_touched(local[p], sh.col_map,
                                             sh.n_touched, total)
            elif total is None:
                total = torch.zeros((n, c1 - c0), dtype=dtype,
                                    device=ctx.out)
            blocks.append(total)
        y = maybe_block(_cat_cols(blocks).to(dtype))
    return y[:, 0] if ctx.squeeze else y


def _symmetric_combine(multiply, sharded: ShardedSellCS,
                       x: torch.Tensor) -> torch.Tensor:
    """One-triangle symmetric multiply: ``A X = N(X) + T(X) - diag * X``
    over the stored triangle (``op`` is moot, ``A == A^T``)."""
    x2, squeeze = _as_2d(x)
    general = sharded._replace(structure="general")
    y_n = multiply(general, x2, op="N")
    y_t = multiply(general, x2, op="T")
    y = y_n + y_t - (sharded.diag.to(y_n.device, y_n.dtype)[:, None]
                     * x2.to(y_n.dtype))
    return y[:, 0] if squeeze else y


def spmm_row_distributed(sharded: ShardedSellCS, x: torch.Tensor, mesh,
                         axis: str = "data", *, impl: str = "auto",
                         k_tile: Optional[int] = None,
                         model_axis: Optional[str] = None,
                         compact_x: Optional[bool] = None, op: str = "N",
                         gather: Optional[str] = None) -> torch.Tensor:
    """``Y = A @ X`` with slice banding: X replicated along ``axis``, each
    shard writes its own local slots, which the fixup copies to their
    global slots through ``slice_offset`` before the σ-unpermute — no sum
    across shards. A ``model`` mesh axis splits the X/Y columns.

    ``impl``: "kernel" (K1/K8/K3 on CUDA), "plain" (their plain versions),
    "ref" (the oracles), "auto" (kernel on a CUDA mesh, else ref);
    ``k_tile`` is accepted for the reference's signature and ignored (the
    kernels cover all k). ``compact_x=`` only asserts the partition-time
    choice. ``gather``: "upfront" (default) gathers each shard's slab
    before its kernel, "fused" runs K8 on the full X, "overlap" falls back
    to up-front (no span loop here); all bitwise equal. ``op='T'``
    computes ``A^T X`` (``X: [m, k]``) with K3 and sums the shards'
    column-space partials (compact: scatters each through its map).
    Symmetric partitions combine both passes."""
    if sharded.structure == "symmetric":
        return _symmetric_combine(
            lambda s, xx, op: spmm_row_distributed(
                s, xx, mesh, axis, impl=impl, model_axis=model_axis,
                compact_x=compact_x, op=op, gather=gather),
            sharded, x)
    ctx = _prep(sharded, x, mesh, axis, impl, "row", model_axis, compact_x,
                op)
    gmode = _resolve_gather(gather, ctx.compact)
    m, n = sharded.shape
    if sharded.nnz == 0:
        return _zeros(sharded, ctx, n if op == "T" else m)
    if op == "T":
        return _transpose(sharded, ctx, [sharded.shards])
    if gmode == "overlap":
        gmode = "upfront"
    C, S = sharded.chunk, sharded.num_slices
    with span("spmm/mesh"):
        parts = _normal_pass(sharded.shards,
                             _feeds(sharded.shards, ctx, gmode), ctx,
                             gmode, C)
    with span("spmm/fixup"):
        blocks = []
        for j, (c0, c1) in enumerate(ctx.col_ranges):
            # shard p owns global slices [t_first, t_first + t_slices):
            # the bands tile [0, S) in order, so the slot array is the
            # concatenation of each shard's leading local slots
            pieces = []
            for p, sh in enumerate(sharded.shards):
                ns = int(sh.t_ptr.shape[0]) - 1
                if parts[j][p] is not None:
                    pieces.append(parts[j][p][:ns * C].to(ctx.out))
                elif ns:
                    pieces.append(torch.zeros(
                        (ns * C, c1 - c0), dtype=_out_dtype(sharded, ctx),
                        device=ctx.out))
            blocks.append(torch.cat(pieces, dim=0))
        y_slots = _cat_cols(blocks)
        assert y_slots.shape[0] == S * C
        return maybe_block(_unpermute(sharded, y_slots, ctx))


def spmm_merge_distributed(sharded: ShardedSellCS, x: torch.Tensor, mesh,
                           axis: str = "data", *, impl: str = "auto",
                           k_tile: Optional[int] = None,
                           num_chunks: int = 1,
                           model_axis: Optional[str] = None,
                           compact_x: Optional[bool] = None, op: str = "N",
                           gather: Optional[str] = None) -> torch.Tensor:
    """``Y = A @ X`` with equal-width spans: every shard writes a partial
    over the whole slot space and the partials are summed on the output
    device (the reference's psum). ``num_chunks > 1`` runs the baked (or,
    for another depth, a freshly dealt) span plan: span ``i``'s partials
    are summed right after its kernels, and the spans' slot blocks
    concatenate. A ``model`` mesh axis splits the X/Y columns; the sums
    run per column block.

    ``gather``: "upfront" (default; through the chunk plan's own map when
    chunked), "overlap" (each span builds its piece of the slab from its
    touched split right before its kernel; up-front without spans),
    "fused" (K8 on the full X); all bitwise equal. ``op='T'`` adds each
    span's column-space partials (compact: scatter through the plan map).
    See :func:`spmm_row_distributed` for ``impl`` and ``k_tile``."""
    if sharded.structure == "symmetric":
        return _symmetric_combine(
            lambda s, xx, op: spmm_merge_distributed(
                s, xx, mesh, axis, impl=impl, num_chunks=num_chunks,
                model_axis=model_axis, compact_x=compact_x, op=op,
                gather=gather),
            sharded, x)
    nc = int(num_chunks)
    if nc < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    ctx = _prep(sharded, x, mesh, axis, impl, "merge", model_axis,
                compact_x, op)
    gmode = _resolve_gather(gather, ctx.compact)
    m, n = sharded.shape
    if sharded.nnz == 0:
        return _zeros(sharded, ctx, n if op == "T" else m)
    C = sharded.chunk
    if nc == 1:
        passes = [sharded.shards]
        if gmode == "overlap":
            gmode = "upfront"
    else:
        plan = sharded.chunk_plan
        if plan is None or plan[0] != nc:
            spans = _chunk_substreams(sharded, nc,
                                      devices=_shard_devices(sharded)).spans
        else:
            spans = plan[1]
        passes = [sp.shards for sp in spans]
    if op == "T":
        return _transpose(sharded, ctx, passes)
    dtype = _out_dtype(sharded, ctx)
    with span("spmm/mesh"):
        feeds = _feeds(passes[0], ctx, gmode)
        rows = []                  # per pass: per column block, summed
        for i, shards in enumerate(passes):
            parts = _normal_pass(shards, feeds, ctx, gmode, C,
                                 label=f"spmm/gather_x/span{i}")
            ns = shards[0].num_slices
            sums = []
            for j, (c0, c1) in enumerate(ctx.col_ranges):
                live = [y for y in parts[j] if y is not None]
                sums.append(_psum(live, ctx.out) if live else torch.zeros(
                    (ns * C, c1 - c0), dtype=dtype, device=ctx.out))
            rows.append(_cat_cols(sums))
    with span("spmm/fixup"):
        y_slots = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
        return maybe_block(_unpermute(sharded, y_slots, ctx))


__all__ = ["ShardedSellCS", "GATHER_MODES", "partition_sellcs_rows",
           "partition_sellcs_nnz", "rechunk_sellcs", "redeal_sellcs",
           "spmm_row_distributed", "spmm_merge_distributed"]
