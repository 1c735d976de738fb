"""SpMM kernel wrappers for Hopper — SELL-C-σ (K1), the same with the
compact-X gather fused in (K8), its transpose (K3), merge-path CSR (K2) and
the k-tiled blocked-format multiply (K6).

K1 :func:`sellcs_slots` replaces ``repro.spmm.kernels.sellcs_slots`` /
``_sellcs_kernel``; K8 is the same wrapper given a ``col_map`` and
replaces ``sellcs_slots(col_map=…)`` / ``_sellcs_fused_kernel``; K3
:func:`sellcs_slots_t` replaces
``repro.spmm.kernels.sellcs_slots_t`` / ``_sellcs_t_kernel``; K2
:func:`_merge_spmm_partials` replaces
``repro.spmm.kernels._merge_spmm_partials`` / ``_merge_kernel``; K6
:func:`tiled_spmm` replaces ``repro.spmm.kernels.tiled_spmm`` /
``_tiled_kernel``. All are CUDA C++ in ``repro_torch/csrc`` (see the
notes in each source for the bound and the design). Each wrapper
validates its operands,
launches on the current stream, raises on a launch error and counts its
launches in ``<wrapper>.launches`` (K8's in ``sellcs_slots.fused_launches``). A wrapper given CPU tensors runs its
plain PyTorch version instead (``*_plain`` here and in
``repro_torch.kernels.merge_spmv``); a CUDA tensor always launches the
kernel.

K1, K8, K2 and K3 cover all k columns in one launch and tile the columns
inside the kernel, so the matrix stream is read once per multiply; they
accept the reference's ``k_tile`` and ignore it. K6 checks the
reference's column tile ``k_tile`` (default :func:`choose_k_tile`) but,
like K7, reads the tile stream once per multiply whatever it is: every
column of a staged tile is done by the warp that holds it. ``choose_k_tile``
keeps the reference's contract (``1 <= kt <= k``) re-derived for the
card: there is no VMEM slab to fit, so only the roofline rule is left
(past the float32 ridge more columns per pass buy nothing).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.formats import CSR
from repro_torch.kernels import _lib
from repro_torch.kernels import bsr_spmv as _bsr
from repro_torch.kernels import merge_spmv as _merge
from repro_torch.kernels.tiling import TiledSparse
from repro_torch.roofline.analysis import csr_stream_bytes, ridge_intensity
from .reference import sellcs_slot_x
from .sellcs import SellCS

# plain-version work is chunked over width-rows so its [w, C, k] temporary
# stays below this many elements
_PLAIN_CHUNK_ELEMS = 1 << 25


def choose_k_tile(shape: Tuple[int, int], k: int, *,
                  nnz: Optional[int] = None, dtype_bytes: int = 4) -> int:
    """Columns per kernel pass: the smallest KT whose modelled intensity
    reaches the float32 ridge of the card (more reuse is compute-bound),
    else all of ``k``. Always ``1 <= KT <= k``."""
    m, n = shape
    kt = max(int(k), 1)
    if nnz:
        ridge = ridge_intensity()
        mat_bytes = csr_stream_bytes(nnz, m, dtype_bytes)
        vec_bytes = (m + n) * dtype_bytes
        denom = 2.0 * nnz - ridge * vec_bytes
        if denom > 0:
            kt = min(kt, max(int(ridge * mat_bytes / denom) + 1, 1))
    return max(min(kt, int(k)), 1)


# --------------------------------------------------------------------------
# K1: SELL-C-σ slot-space SpMM
# --------------------------------------------------------------------------
def sellcs_slots_plain(data: torch.Tensor, cols: torch.Tensor,
                       slice_ptr: torch.Tensor, x: torch.Tensor, *,
                       num_slices: int, chunk: int,
                       col_map: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of K1 (and of K8 with ``col_map``): f32 slot
    sums [num_slices*chunk, k] over the width-row stream (no row
    permutation applied)."""
    W = int(data.shape[0])
    k = int(x.shape[1])
    dev = x.device
    x = x.to(torch.float32)
    y = torch.zeros((num_slices * chunk, k), dtype=torch.float32, device=dev)
    if W == 0:
        return y
    widths = (slice_ptr[1:] - slice_ptr[:-1]).long()
    slice_of = torch.repeat_interleave(
        torch.arange(num_slices, device=dev), widths)
    lanes = torch.arange(chunk, device=dev)
    step = max(_PLAIN_CHUNK_ELEMS // max(chunk * k, 1), 1)
    for w0 in range(0, W, step):
        sl = slice(w0, min(w0 + step, W))
        c = cols[sl].long()
        if col_map is not None:
            c = col_map[c].long()
        contrib = data[sl].to(torch.float32)[:, :, None] * x[c]  # [w, C, k]
        slot = slice_of[sl][:, None] * chunk + lanes[None]
        y.index_add_(0, slot.reshape(-1), contrib.reshape(-1, k))
    return y


def sellcs_slots(data: torch.Tensor, cols: torch.Tensor,
                 slice_ptr: torch.Tensor, x: torch.Tensor, *,
                 num_slices: int, chunk: int,
                 col_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``Y[s*C + l, :] = Σ_w data[w, l] * X[cols[w, l], :]`` over the
    width-rows ``w`` of slice ``s`` -> f32[num_slices*chunk, k].

    With ``col_map`` (int32[Ntc]) this is K8: ``cols`` are compact ids and
    each entry reads ``X[col_map[cols[w, l]], :]`` of the full X — the
    gather fused into the stream, bitwise equal to K1 on the gathered slab
    ``X[col_map]``. Counted in ``sellcs_slots.fused_launches``."""
    if x.device.type == "cpu":
        return sellcs_slots_plain(data, cols, slice_ptr, x,
                                  num_slices=num_slices, chunk=chunk,
                                  col_map=col_map)
    _lib.require(data, "data", torch.float32, 2)
    _lib.require(cols, "cols", torch.int32, 2)
    _lib.require(slice_ptr, "slice_ptr", torch.int32, 1)
    _lib.require(x, "x", torch.float32, 2)
    if col_map is not None:
        _lib.require(col_map, "col_map", torch.int32, 1)
    if data.shape != cols.shape or data.shape[1] != chunk:
        raise ValueError(f"data/cols must be [W, {chunk}], got "
                         f"{tuple(data.shape)} / {tuple(cols.shape)}")
    if slice_ptr.shape[0] != num_slices + 1:
        raise ValueError("slice_ptr must have num_slices + 1 entries")
    k = int(x.shape[1])
    y = torch.empty((num_slices * chunk, k), dtype=torch.float32,
                    device=x.device)
    if col_map is None:
        fn = "sellcs_slots_launch"
        _lib.check(_lib.entry(fn)(data.data_ptr(), cols.data_ptr(),
                                  slice_ptr.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), num_slices, chunk, k,
                                  _lib.stream_of(x)), fn)
        sellcs_slots.launches += 1
        return y
    fn = "sellcs_slots_fused_launch"
    _lib.check(_lib.entry(fn)(data.data_ptr(), cols.data_ptr(),
                              col_map.data_ptr(), slice_ptr.data_ptr(),
                              x.data_ptr(), y.data_ptr(), num_slices, chunk,
                              k, _lib.stream_of(x)), fn)
    sellcs_slots.fused_launches += 1
    return y


sellcs_slots.launches = 0
sellcs_slots.fused_launches = 0


def slice_ptr_of(slice_of: torch.Tensor, num_slices: int) -> torch.Tensor:
    """int32[num_slices + 1] width offsets of a stream whose slice ids
    ``slice_of`` are nondecreasing (a real width-row prefix)."""
    ptr = torch.zeros(num_slices + 1, dtype=torch.int64,
                      device=slice_of.device)
    if slice_of.numel():
        ptr[1:] = torch.cumsum(torch.bincount(slice_of.long(),
                                              minlength=num_slices), 0)
    return ptr.to(torch.int32)


def sellcs_slots_chunk(data: torch.Tensor, cols: torch.Tensor,
                       slice_of: torch.Tensor, x: torch.Tensor, *,
                       slice_start: int, num_slices: int, chunk: int,
                       col_map: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K1 (K8 with ``col_map``) over one chunk sub-stream whose ``slice_of``
    is still GLOBAL, rebased to the chunk-local slot space
    ``[num_slices * chunk, k]`` that starts at global slice
    ``slice_start``. The reference clips the padding rows' ids into range;
    the CUDA kernels take a slice pointer instead of ids, so here the
    stream must be the real prefix (ids nondecreasing, inside the span)."""
    local = slice_of.long() - slice_start
    return sellcs_slots(data, cols, slice_ptr_of(local, num_slices), x,
                        num_slices=num_slices, chunk=chunk, col_map=col_map)


# --------------------------------------------------------------------------
# K3: SELL-C-σ transpose pass
# --------------------------------------------------------------------------
def sellcs_slots_t_plain(data: torch.Tensor, cols: torch.Tensor,
                         slice_of: torch.Tensor, slice_ptr: torch.Tensor,
                         row_len: torch.Tensor, x_slots: torch.Tensor, *,
                         n_out: int, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of K3: f32 ``[n_out, k]`` column sums of
    ``data[w, l] * x_slots[slice_of[w]*C + l]`` over the stored entries,
    padding entries (depth ``>= row_len``) skipped as the kernel does."""
    W = int(data.shape[0])
    k = int(x_slots.shape[1])
    dev = x_slots.device
    x_slots = x_slots.to(torch.float32)
    y = torch.zeros((n_out, k), dtype=torch.float32, device=dev)
    if W == 0:
        return y
    lanes = torch.arange(chunk, device=dev)
    step = max(_PLAIN_CHUNK_ELEMS // max(chunk * k, 1), 1)
    for w0 in range(0, W, step):
        w = torch.arange(w0, min(w0 + step, W), device=dev)
        s = slice_of[w].long()
        slot = s[:, None] * chunk + lanes[None]                 # [w, C]
        real = (w - slice_ptr[s])[:, None] < row_len[slot]
        contrib = (data[w][real].to(torch.float32)[:, None]
                   * x_slots[slot[real]])                       # [e, k]
        y.index_add_(0, cols[w][real].long(), contrib)
    return y


def column_bands(n_out: int, k: int, l2_bytes: int) -> int:
    """How many passes K3 takes over Y's columns: one while the f32
    ``[n_out, k]`` Y fits two thirds of L2 (the rest holds the stream as
    it passes), else as many bands as keep each one that small, so the
    scattered adds of a pass hit L2 instead of HBM."""
    budget = max(2 * l2_bytes // 3, 1)
    y_bytes = 4 * n_out * k
    return max(1, min(-(-y_bytes // budget), n_out))


def _sellcs_t_launch(data, cols, slice_of, slice_ptr, row_len, x_slots,
                     y, chunk: int, bands: int) -> None:
    """Launch K3 into the zeroed ``y`` in ``bands`` column passes
    (uncounted: :func:`sellcs_slots_t` counts its calls)."""
    n_out, k = int(y.shape[0]), int(y.shape[1])
    fn = "sellcs_slots_t_launch"
    _lib.check(_lib.entry(fn)(data.data_ptr(), cols.data_ptr(),
                              slice_of.data_ptr(), slice_ptr.data_ptr(),
                              row_len.data_ptr(), x_slots.data_ptr(),
                              y.data_ptr(), int(data.shape[0]), chunk, k,
                              n_out, bands, _lib.stream_of(x_slots)), fn)


def sellcs_slots_t(data: torch.Tensor, cols: torch.Tensor,
                   slice_of: torch.Tensor, slice_ptr: torch.Tensor,
                   row_len: torch.Tensor, x_slots: torch.Tensor, *,
                   n_out: int, chunk: int) -> torch.Tensor:
    """K3: ``Y[cols[w, l], :] += data[w, l] * x_slots[slice_of[w]*C + l, :]``
    over the stored entries -> f32[n_out, k] in natural column order.
    ``x_slots`` is X permuted into slot space
    (:func:`repro_torch.spmm.reference.sellcs_slot_x`); ``slice_ptr`` is
    each slice's depth base and the stream its real width-row prefix
    (slice ids nondecreasing). The adds are atomic, so their order (and
    the last bits) vary from run to run. A Y larger than two thirds of L2
    is updated in :func:`column_bands` passes."""
    if x_slots.device.type == "cpu":
        return sellcs_slots_t_plain(data, cols, slice_of, slice_ptr,
                                    row_len, x_slots, n_out=n_out,
                                    chunk=chunk)
    _lib.require(data, "data", torch.float32, 2)
    _lib.require(cols, "cols", torch.int32, 2)
    _lib.require(slice_of, "slice_of", torch.int32, 1)
    _lib.require(slice_ptr, "slice_ptr", torch.int32, 1)
    _lib.require(row_len, "row_len", torch.int32, 1)
    _lib.require(x_slots, "x_slots", torch.float32, 2)
    W = int(data.shape[0])
    S = int(slice_ptr.shape[0]) - 1
    if data.shape != cols.shape or data.shape[1] != chunk:
        raise ValueError(f"data/cols must be [W, {chunk}], got "
                         f"{tuple(data.shape)} / {tuple(cols.shape)}")
    if slice_of.shape[0] != W or row_len.shape[0] != S * chunk \
            or x_slots.shape[0] != S * chunk:
        raise ValueError("slice_of must be [W], row_len and x_slots "
                         "[num_slices * chunk]")
    k = int(x_slots.shape[1])
    y = torch.zeros((n_out, k), dtype=torch.float32, device=x_slots.device)
    bands = column_bands(n_out, k, _lib.l2_bytes(x_slots.device))
    _sellcs_t_launch(data, cols, slice_of, slice_ptr, row_len, x_slots, y,
                     chunk, bands)
    sellcs_slots_t.launches += 1
    return y


sellcs_slots_t.launches = 0


def _sellcs_t_pass(sc: SellCS, x: torch.Tensor, plain: bool) -> torch.Tensor:
    """``A_stored^T X`` (``X: [m, k]`` f32) -> f32[n, k]: the slot-X gather
    (a torch ``index_select``, as the reference gathers outside its
    kernel), then K3."""
    xs = sellcs_slot_x(sc.row_perm, x, sc.shape[0])
    fn = sellcs_slots_t_plain if plain else sellcs_slots_t
    return fn(sc.data, sc.cols, sc.slice_of, sc.slice_ptr, sc.row_len, xs,
              n_out=sc.shape[1], chunk=sc.chunk)


def sellcs_spmm(sc: SellCS, x: torch.Tensor, *, k_tile: Optional[int] = None,
                plain: bool = False, op: str = "N") -> torch.Tensor:
    """SELL-C-σ SpMM ``Y = A X`` (``X: [n, k]``) -> f32[m, k]: K1 over the
    slice stream, then the σ-sort permutation is undone by one scatter
    (padding slots land on row m, dropped).

    ``op='T'`` computes ``Y = A^T X`` (``X: [m, k]``) -> f32[n, k] with K3.
    Symmetric one-triangle storage combines both passes over the stored
    triangle (``A X = N(X) + T(X) - diag * X``), for which ``op='T'`` and
    ``op='N'`` coincide. ``plain=True`` runs the kernels' plain versions on
    any device; ``k_tile`` is ignored (the kernels cover all k)."""
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    m, n = sc.shape
    k = int(x.shape[1])
    dev = x.device
    if x.shape[0] != (m if op == "T" else n):
        raise ValueError(f"X must have {m if op == 'T' else n} rows for "
                         f"op={op!r} on a {m}x{n} matrix, got "
                         f"{tuple(x.shape)}")
    x = x.to(torch.float32).contiguous()
    sym = sc.structure == "symmetric"
    if op == "T" and not sym:
        if sc.nnz == 0:
            return torch.zeros((n, k), dtype=torch.float32, device=dev)
        return _sellcs_t_pass(sc, x, plain)
    if sc.nnz == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=dev)
    slots_fn = sellcs_slots_plain if plain else sellcs_slots
    y_slots = slots_fn(sc.data, sc.cols, sc.slice_ptr, x,
                       num_slices=sc.num_slices, chunk=sc.chunk)
    y = torch.zeros((m + 1, k), dtype=torch.float32, device=dev)
    y = y.index_add_(0, sc.row_perm.long(), y_slots)[:m]
    if sym:
        y += _sellcs_t_pass(sc, x, plain)
        y -= sc.diag.to(torch.float32)[:, None] * x
    return y


# --------------------------------------------------------------------------
# K2: merge-path CSR SpMM
# --------------------------------------------------------------------------
def _merge_spmm_partials(plan: _merge.MergePlan, x: torch.Tensor, m: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: merge-path SpMM partials for ``x`` f32[n, k] ->
    ``(y f32[m, k], carry_row i32[2P], carry_val f32[2P, k])`` — rows
    wholly inside one span in ``y``, each span's first and last rows as
    carries for :func:`repro_torch.kernels.merge_spmv.carry_out_fixup`."""
    if x.device.type == "cpu":
        return _merge.merge_partials_plain(plan, x, m)
    _merge._check_plan(plan)
    _lib.require(x, "x", torch.float32, 2)
    P, D = plan.cols.shape
    k = int(x.shape[1])
    y = torch.zeros((m, k), dtype=torch.float32, device=x.device)
    carry_row = torch.empty(2 * P, dtype=torch.int32, device=x.device)
    carry_val = torch.empty((2 * P, k), dtype=torch.float32, device=x.device)
    fn = "merge_spmm_partials_launch"
    _lib.check(_lib.entry(fn)(
        plan.cols.data_ptr(), plan.vals.data_ptr(), plan.seg.data_ptr(),
        plan.row_starts.data_ptr(), plan.span_len.data_ptr(), x.data_ptr(),
        y.data_ptr(), carry_row.data_ptr(), carry_val.data_ptr(), P, D, k,
        _lib.stream_of(x)), fn)
    _merge_spmm_partials.launches += 1
    return y, carry_row, carry_val


_merge_spmm_partials.launches = 0


def csr_spmm(csr: CSR, x: torch.Tensor, *,
             plan: Optional[_merge.MergePlan] = None,
             num_spans: Optional[int] = None,
             k_tile: Optional[int] = None,
             plain: bool = False) -> torch.Tensor:
    """Merge-path SpMM on flat CSR -> f32[m, k]: K2 then the carry step.
    The plan is built once per CSR and span count and reused by every
    multiply. ``plain=True`` runs the plain versions on any device;
    ``k_tile`` is ignored (K2 covers all k)."""
    m, _ = csr.shape
    if plan is None:
        plan = _merge.cached_merge_plan(csr, num_spans)
    x = x.to(torch.float32).contiguous()
    if plain:
        y, cr, cv = _merge.merge_partials_plain(plan, x, m)
        return _merge.carry_out_fixup_plain(y, cr, cv)
    y, cr, cv = _merge_spmm_partials(plan, x, m)
    return _merge.carry_out_fixup(y, cr, cv)


# --------------------------------------------------------------------------
# K6: k-tiled SpMM over the mini-tile stream (TiledSparse)
# --------------------------------------------------------------------------
def tiled_spmm_plain(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: X [n, k] -> f32 [m, k]. Its answer does
    not depend on the column tile, so it takes all k columns at once."""
    return _bsr.tiled_products_plain(ts.tiles, ts.tile_rows, ts.tile_cols,
                                     x, ts.shape)


def tiled_spmm(ts: TiledSparse, x: torch.Tensor, *,
               k_tile: Optional[int] = None,
               plain: bool = False) -> torch.Tensor:
    """K6: ``Y = A X`` over the dense-mini-tile stream for a column tile
    of ``k_tile`` columns (default :func:`choose_k_tile`; the kernel reads
    the stream once whatever it is) -> f32 [m, k]. Serves every blocked
    paper format (their compute form is ``TiledSparse``). ``plain=True``,
    or CPU tensors, run the plain version. The adds into Y are atomic,
    so their order (and the last bits) vary from run to run."""
    m, n = ts.shape
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"X must be [{n}, k], got {tuple(x.shape)}")
    k = int(x.shape[1])
    kt = k_tile or choose_k_tile(ts.shape, k, nnz=ts.nnz)
    if not 1 <= kt <= k:
        raise ValueError(f"k_tile must be in [1, {k}], got {kt}")
    if plain or x.device.type == "cpu":
        return tiled_spmm_plain(ts, x)
    y = _bsr.tiled_spmm_launch(ts, x)
    tiled_spmm.launches += 1
    return y


tiled_spmm.launches = 0
