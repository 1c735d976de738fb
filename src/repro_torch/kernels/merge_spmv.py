"""Merge-path SpMV on flat CSR (paper §3.3) — kernel K4 and the carry step.

Merrill & Garland's algorithm cuts the merge path over (row ends, nonzeros)
into P equal-diagonal spans, so every span does the same number of
(FMA | row-close) operations — perfect balance for any row distribution,
including the mawi single-dense-row pathology.

The plan (:func:`merge_plan`) is the reference's fixed-shape per-span
record: ``cols``/``vals``/``seg`` [P, D] (``seg`` = row index local to the
span, padding items carry seg == 0, val == 0, col == 0) plus
``row_starts`` [P+1]. The port adds ``span_len`` [P], the real item count
of each span, so the kernel never reads padding. The plan is built once
per matrix from the host arrays the CSR keeps at convert time and cached
on the CSR (:func:`cached_merge_plan`); ``SparseOperator`` builds it when
it realizes a CSR plan, so conversion pays for it. The reference rebuilds
it on every multiply.

Kernels (``csrc/merge_spmm.cu``):

* :func:`merge_spmv_partials` — K4, replaces ``repro.kernels.merge_spmv.
  merge_spmv_partials``. It writes every row that lies wholly inside one
  span straight into ``y`` and returns each span's first and last rows
  (the only rows a neighbouring span can share) as carries
  ``carry_row`` i32[2P] (global row id, -1 for none) and ``carry_val``.
* :func:`carry_out_fixup` — replaces ``repro.kernels.merge_spmv.
  carry_out_fixup``: adds every row's carries into ``y`` (one warp per
  run of carries that name one row).
* :func:`merge_spmv_fused` — the whole SpMV from one host call (the C
  entry ``merge_spmv_launch``): the memset of ``y``, K4 and the carry
  step, the last launched as a programmatic dependent of K4. The
  multiply's path (``kernels.ops.merge_spmv``) takes it; the two wrappers
  above mirror the reference's API and give the same bits in two calls.

``y`` and the carries share one allocation (:func:`merge_out_views`). No
(P, R) or (P, R, k) partials buffer exists. Each wrapper takes its
plain PyTorch version (the ``*_plain`` functions below) only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR
from repro_torch.core.mergepath import merge_path_partition_np
from . import _lib

# plain-version work is chunked over spans so its [spans, D, k] temporary
# stays below this many elements
_PLAIN_CHUNK_ELEMS = 1 << 25


def default_num_spans(m: int, nnz: int) -> int:
    """Span-count heuristic shared by the SpMV and SpMM merge paths: one
    span per ~4096 merge items, clamped to [8, 1024]."""
    return max(min((m + nnz) // 4096, 1024), 8)


@dataclasses.dataclass(eq=False)
class MergePlan:
    cols: torch.Tensor         # int32[P, D]
    vals: torch.Tensor         # f32[P, D]
    seg: torch.Tensor          # int32[P, D] — row index local to the span
    row_starts: torch.Tensor   # int32[P+1]
    span_len: torch.Tensor     # int32[P] — real items per span
    r_width: int               # R — the reference's padded local row width
    # the arrays the kernel wrappers last validated (``_check_plan``) and
    # their device pointers
    _checked: tuple = dataclasses.field(default=(), init=False, repr=False,
                                        compare=False)
    _ptrs: tuple = dataclasses.field(default=(), init=False, repr=False,
                                     compare=False)

    @property
    def num_spans(self) -> int:
        return int(self.cols.shape[0])

    @property
    def depth(self) -> int:
        return int(self.cols.shape[1])


def merge_plan(csr: CSR, num_spans: int) -> MergePlan:
    """Plan-time merge-path partition -> fixed-shape per-span records on the
    CSR's device, built from its host arrays (vectorized numpy)."""
    row_ptr, col_ind, data = csr.host_arrays()
    row_ptr = np.asarray(row_ptr, np.int64)
    m = row_ptr.shape[0] - 1
    nnz = int(row_ptr[-1])
    P = int(num_spans)
    D = max(-(-(m + nnz) // P), 1)
    R = max(-(-(D + 1) // 128) * 128, 128)

    row_starts, nnz_starts = merge_path_partition_np(row_ptr, P)
    cols = np.zeros((P, D), np.int32)
    vals = np.zeros((P, D), data.dtype if data.size else np.float32)
    seg = np.zeros((P, D), np.int32)
    if nnz:
        j = np.arange(nnz, dtype=np.int64)
        p = np.searchsorted(nnz_starts.astype(np.int64), j, side="right") - 1
        i = j - nnz_starts[p]
        row_of_nnz = np.searchsorted(row_ptr, j, side="right") - 1
        cols[p, i] = col_ind
        vals[p, i] = data
        seg[p, i] = row_of_nnz - row_starts[p]
    span_len = np.diff(nnz_starts.astype(np.int64)).astype(np.int32)
    dev = csr.device
    return MergePlan(torch.from_numpy(cols).to(dev),
                     torch.from_numpy(vals).to(dev),
                     torch.from_numpy(seg).to(dev),
                     torch.from_numpy(row_starts.astype(np.int32)).to(dev),
                     torch.from_numpy(span_len).to(dev), int(R))


def cached_merge_plan(csr: CSR, num_spans: Optional[int] = None) -> MergePlan:
    """The CSR's merge plan for ``num_spans`` (default
    :func:`default_num_spans`), built on first use and kept on the CSR so
    every later multiply reuses it."""
    m, _ = csr.shape
    if num_spans is None:
        num_spans = default_num_spans(m, csr.nnz)
    plan = csr.plans.get(int(num_spans))
    if plan is None:
        plan = csr.plans.setdefault(int(num_spans),
                                    merge_plan(csr, int(num_spans)))
    return plan


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU tests; compared with the kernels on the card)
# --------------------------------------------------------------------------
def merge_partials_plain(plan: MergePlan, x2: torch.Tensor, m: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function the partials kernels compute, on a 2-D ``x2`` [n, k]:
    ``(y f32[m, k], carry_row i32[2P], carry_val f32[2P, k])`` where ``y``
    holds every row wholly inside one span and the carries hold each span's
    first and last rows (second slot -1 when the span has one row)."""
    P, D = plan.cols.shape
    k = x2.shape[1]
    dev = x2.device
    x2 = x2.to(torch.float32)
    y = torch.zeros((m, k), dtype=torch.float32, device=dev)
    carry_row = torch.full((P, 2), -1, dtype=torch.int32, device=dev)
    carry_val = torch.zeros((P, 2, k), dtype=torch.float32, device=dev)
    step = max(_PLAIN_CHUNK_ELEMS // max(D * k, 1), 1)
    idx = torch.arange(D, device=dev)
    for p0 in range(0, P, step):
        sl = slice(p0, min(p0 + step, P))
        ln = plan.span_len[sl].long()
        valid = idx[None] < ln[:, None]                          # [p, D]
        rows = plan.row_starts[:-1][sl].long()[:, None] + plan.seg[sl].long()
        first = rows[:, 0]
        last = rows.gather(1, (ln - 1).clamp(min=0)[:, None])[:, 0]
        nonempty = ln > 0
        two = nonempty & (last != first)
        is0 = valid & (rows == first[:, None])
        is1 = valid & (rows == last[:, None]) & two[:, None]
        inner = valid & ~is0 & ~is1
        contrib = (plan.vals[sl].to(torch.float32)[:, :, None]
                   * x2[plan.cols[sl].long()])                   # [p, D, k]
        y.index_add_(0, rows[inner], contrib[inner])
        carry_val[sl, 0] = (contrib * is0[:, :, None]).sum(1)
        carry_val[sl, 1] = (contrib * is1[:, :, None]).sum(1)
        carry_row[sl, 0] = torch.where(nonempty, first, -1).to(torch.int32)
        carry_row[sl, 1] = torch.where(two, last, -1).to(torch.int32)
    return y, carry_row.reshape(-1), carry_val.reshape(2 * P, k)


def carry_out_fixup_plain(y: torch.Tensor, carry_row: torch.Tensor,
                          carry_val: torch.Tensor) -> torch.Tensor:
    """Add every carry into its row of ``y`` (in place); returns ``y``."""
    keep = carry_row >= 0
    y2 = y if y.ndim == 2 else y[:, None]
    cv = carry_val if carry_val.ndim == 2 else carry_val[:, None]
    y2.index_add_(0, carry_row[keep].long(), cv[keep])
    return y


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------
def _check_plan(plan: MergePlan) -> tuple:
    """Validate the plan's arrays before their pointers go to C; a plan
    whose arrays are the ones last checked is not checked again. Returns
    the arrays' device pointers (cols, vals, seg, row_starts, span_len)."""
    arrays = (plan.cols, plan.vals, plan.seg, plan.row_starts,
              plan.span_len)
    if plan._ptrs and all(a is b for a, b in zip(arrays, plan._checked)):
        return plan._ptrs
    P = plan.num_spans
    _lib.require(plan.cols, "plan.cols", torch.int32, 2)
    _lib.require(plan.vals, "plan.vals", torch.float32, 2)
    _lib.require(plan.seg, "plan.seg", torch.int32, 2)
    _lib.require(plan.row_starts, "plan.row_starts", torch.int32, 1)
    _lib.require(plan.span_len, "plan.span_len", torch.int32, 1)
    if plan.row_starts.shape[0] != P + 1 or plan.span_len.shape[0] != P:
        raise ValueError("plan.row_starts / plan.span_len do not match P")
    plan._checked = arrays
    plan._ptrs = tuple(a.data_ptr() for a in arrays)
    return plan._ptrs


def merge_out(m: int, k: int, P: int, device) -> torch.Tensor:
    """The one allocation of a merge multiply of ``m`` rows, ``k`` columns
    and ``P`` spans (uninitialized: the C entries zero ``y`` and write
    every carry); :func:`merge_out_views` cuts it."""
    return torch.empty(m * k + 2 * P * (k + 1), dtype=torch.float32,
                       device=device)


def merge_out_views(buf: torch.Tensor, m: int, k: int, P: int,
                    vector: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, carry_row, carry_val)`` in ``buf`` as ``csrc/merge_spmm.cu``
    lays them out (``MergeOut``): ``y`` f32[m, k] at offset 0, then
    ``carry_row`` i32[2P], then ``carry_val`` f32[2P, k]; ``vector``
    (K4, k = 1) gives ``y`` f32[m] and ``carry_val`` f32[2P]."""
    mk = m * k
    y = buf[:mk]
    carry_row = buf[mk:mk + 2 * P].view(torch.int32)
    carry_val = buf[mk + 2 * P:mk + 2 * P * (k + 1)]
    if not vector:
        y, carry_val = y.view(m, k), carry_val.view(2 * P, k)
    return y, carry_row, carry_val


def merge_call(fn: str, plan: MergePlan, x: torch.Tensor, m: int
               ) -> torch.Tensor:
    """Validate a CUDA merge multiply's operands and call the C entry
    ``fn`` (K4's for ``x`` f32[n], K2's for ``x`` f32[n, k]; the whole
    multiply or its partials) on the current stream. Returns the one
    allocation it filled (:func:`merge_out_views`)."""
    ptrs = _check_plan(plan)
    _lib.require(x, "x", torch.float32, x.ndim)
    P, D = plan.cols.shape
    k = () if x.ndim == 1 else (int(x.shape[1]),)
    buf = merge_out(m, k[0] if k else 1, P, x.device)
    _lib.check(_lib.entry(fn)(*ptrs, x.data_ptr(), buf.data_ptr(), P, D, m,
                              *k, _lib.stream_of(x)), fn)
    return buf


def merge_spmv_partials(plan: MergePlan, x: torch.Tensor, m: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: merge-path SpMV partials for ``x`` f32[n] ->
    ``(y f32[m], carry_row i32[2P], carry_val f32[2P])``."""
    if x.ndim != 1:
        raise ValueError(f"x must be [n], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        y, cr, cv = merge_partials_plain(plan, x[:, None], m)
        return y[:, 0], cr, cv[:, 0]
    buf = merge_call("merge_spmv_partials_launch", plan, x, m)
    merge_spmv_partials.launches += 1
    return merge_out_views(buf, m, 1, plan.num_spans, vector=True)


merge_spmv_partials.launches = 0


def merge_spmv_fused(plan: MergePlan, x: torch.Tensor, m: int
                     ) -> torch.Tensor:
    """The whole merge-path SpMV ``y = A x`` for ``x`` f32[n] -> f32[m]
    from one C entry call (``merge_spmv_launch``: the memset of ``y``, K4,
    then the carry step as K4's programmatic dependent); bitwise equal to
    :func:`merge_spmv_partials` followed by :func:`carry_out_fixup`. Counts
    one call (``.calls``) and a launch of each kernel."""
    if x.ndim != 1:
        raise ValueError(f"x must be [n], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        y, cr, cv = merge_partials_plain(plan, x[:, None], m)
        return carry_out_fixup_plain(y, cr, cv)[:, 0]
    buf = merge_call("merge_spmv_launch", plan, x, m)
    merge_spmv_fused.calls += 1
    merge_spmv_partials.launches += 1
    carry_out_fixup.launches += 1
    return buf[:m]


merge_spmv_fused.calls = 0


def carry_out_fixup(y: torch.Tensor, carry_row: torch.Tensor,
                    carry_val: torch.Tensor) -> torch.Tensor:
    """The carry step: add each row's carries into ``y`` ([m] or [m, k])
    in place; returns ``y``."""
    if y.device.type == "cpu":
        return carry_out_fixup_plain(y, carry_row, carry_val)
    k = 1 if y.ndim == 1 else int(y.shape[1])
    _lib.require(y, "y", torch.float32, y.ndim)
    _lib.require(carry_row, "carry_row", torch.int32, 1)
    _lib.require(carry_val, "carry_val", torch.float32, carry_val.ndim)
    n = int(carry_row.shape[0])
    if carry_val.numel() != n * k:
        raise ValueError("carry_val does not match carry_row and y")
    fn = "merge_carry_fixup_launch"
    _lib.check(_lib.entry(fn)(carry_row.data_ptr(), carry_val.data_ptr(),
                              y.data_ptr(), n, k, _lib.stream_of(y)), fn)
    carry_out_fixup.launches += 1
    return y


carry_out_fixup.launches = 0
