"""SpMM kernel wrappers for Hopper — SELL-C-σ (K1) and merge-path CSR (K2).

K1 :func:`sellcs_slots` replaces ``repro.spmm.kernels.sellcs_slots`` /
``_sellcs_kernel``; K2 :func:`_merge_spmm_partials` replaces
``repro.spmm.kernels._merge_spmm_partials`` / ``_merge_kernel``. Both are
CUDA C++ in ``repro_torch/csrc`` (see the notes at the top of each source
for the bound and the design). Each wrapper validates its operands,
launches on the current stream, raises on a launch error and counts its
launches in ``<wrapper>.launches``. A wrapper given CPU tensors runs its
plain PyTorch version instead (``*_plain`` here and in
``repro_torch.kernels.merge_spmv``); a CUDA tensor always launches the
kernel.

Both kernels cover all k columns in one launch and tile the columns
inside the kernel, so the matrix stream is read once per multiply.
``choose_k_tile`` keeps the reference's contract (``1 <= kt <= k``)
re-derived for the card: there is no VMEM slab to fit, so only the
roofline rule is left (past the float32 ridge more columns per pass buy
nothing). The multiplies accept the reference's ``k_tile`` and ignore it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.formats import CSR
from repro_torch.kernels import _lib
from repro_torch.kernels import merge_spmv as _merge
from repro_torch.roofline.analysis import csr_stream_bytes, ridge_intensity
from .reference import TRANSPOSE_SLICE
from .sellcs import SYMMETRIC_SLICE, SellCS

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
                       num_slices: int, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of K1: f32 slot sums [num_slices*chunk, k]
    over the width-row stream (no row permutation applied)."""
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
        contrib = (data[sl].to(torch.float32)[:, :, None]
                   * x[cols[sl].long()])                   # [w, C, k]
        slot = slice_of[sl][:, None] * chunk + lanes[None]
        y.index_add_(0, slot.reshape(-1), contrib.reshape(-1, k))
    return y


def sellcs_slots(data: torch.Tensor, cols: torch.Tensor,
                 slice_ptr: torch.Tensor, x: torch.Tensor, *,
                 num_slices: int, chunk: int) -> torch.Tensor:
    """K1: ``Y[s*C + l, :] = Σ_w data[w, l] * X[cols[w, l], :]`` over the
    width-rows ``w`` of slice ``s`` -> f32[num_slices*chunk, k]."""
    if x.device.type == "cpu":
        return sellcs_slots_plain(data, cols, slice_ptr, x,
                                  num_slices=num_slices, chunk=chunk)
    _lib.require(data, "data", torch.float32, 2)
    _lib.require(cols, "cols", torch.int32, 2)
    _lib.require(slice_ptr, "slice_ptr", torch.int32, 1)
    _lib.require(x, "x", torch.float32, 2)
    if data.shape != cols.shape or data.shape[1] != chunk:
        raise ValueError(f"data/cols must be [W, {chunk}], got "
                         f"{tuple(data.shape)} / {tuple(cols.shape)}")
    if slice_ptr.shape[0] != num_slices + 1:
        raise ValueError("slice_ptr must have num_slices + 1 entries")
    k = int(x.shape[1])
    y = torch.empty((num_slices * chunk, k), dtype=torch.float32,
                    device=x.device)
    fn = "sellcs_slots_launch"
    _lib.check(_lib.entry(fn)(data.data_ptr(), cols.data_ptr(),
                              slice_ptr.data_ptr(), x.data_ptr(),
                              y.data_ptr(), num_slices, chunk, k,
                              _lib.stream_of(x)), fn)
    sellcs_slots.launches += 1
    return y


sellcs_slots.launches = 0


def sellcs_spmm(sc: SellCS, x: torch.Tensor, *, k_tile: Optional[int] = None,
                plain: bool = False, op: str = "N") -> torch.Tensor:
    """SELL-C-σ SpMM ``Y = A X`` (``X: [n, k]``) -> f32[m, k]: K1 over the
    slice stream, then the σ-sort permutation is undone by one scatter
    (padding slots land on row m, dropped). ``plain=True`` runs K1's plain
    version on any device; ``k_tile`` is ignored (K1 covers all k)."""
    if op != "N":
        raise NotImplementedError(TRANSPOSE_SLICE)
    if sc.structure != "general":
        raise NotImplementedError(SYMMETRIC_SLICE)
    m = sc.shape[0]
    k = int(x.shape[1])
    dev = x.device
    if sc.nnz == 0:
        return torch.zeros((m, k), dtype=torch.float32, device=dev)
    slots_fn = sellcs_slots_plain if plain else sellcs_slots
    y_slots = slots_fn(sc.data, sc.cols, sc.slice_ptr,
                       x.to(torch.float32).contiguous(),
                       num_slices=sc.num_slices, chunk=sc.chunk)
    y = torch.zeros((m + 1, k), dtype=torch.float32, device=dev)
    return y.index_add_(0, sc.row_perm.long(), y_slots)[:m]


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
