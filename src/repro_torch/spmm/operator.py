"""repro_torch.spmm.operator — the partition-once/multiply-many handle.

:class:`SparseOperator` owns the immutable COO source and a single
*current* :class:`RealizedPlan`; ``op.matmul(X)`` multiplies with whatever
plan is installed, and ``op.swap(new_plan)`` replaces it atomically — the
plan is one immutable object read exactly once per multiply, so a
concurrent flush sees either the old plan or the new one, never a torn
mix. ``op.realize(spec)`` builds a plan without installing it, which is
what the serve migration controller runs in its background thread.

Every plan also carries ``multiply_t`` (``X -> A^T X`` over the same
converted matrix): ``op.rmatmul``, the ``op.T`` view and the backward
pass of the differentiable :func:`sparse_matmul` run it, so the
transpose never builds a second format.

This port executes single-device plans. Multi-device plans
(``num_devices > 1``, ``shrink_to``) raise ``NotImplementedError``
naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import COO, CSR, BlockedSparse
from repro_torch.core.selector import (MachineSpec, MatrixStats, PlanSpec,
                                       _matrix_bytes_est, matrix_stats,
                                       select)

MESH_SLICE = ("multi-device plans are not ported yet: they come with the "
              "multi-device schedules slice (ROADMAP queue 1, module 9)")


def coo_fingerprint(coo: COO) -> str:
    """Stable content hash of a COO matrix — the same digest as
    ``repro.spmm.operator.coo_fingerprint`` for the same triplets.

    The nonzeros are hashed in canonical ``(rows, cols, values)``
    lexicographic order, so any permutation of the same triplet stream maps
    to the same fingerprint; shape and value dtype are part of the hash."""
    r, c, v = coo.host_triplets()
    rows = np.asarray(r, np.int64)
    cols = np.asarray(c, np.int64)
    vals = np.asarray(v)
    order = np.lexsort((vals, cols, rows))
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((tuple(int(s) for s in coo.shape),
                   str(vals.dtype))).encode())
    h.update(rows[order].tobytes())
    h.update(cols[order].tobytes())
    h.update(vals[order].tobytes())
    return h.hexdigest()


class RealizedPlan(NamedTuple):
    """One executable multiply plan: the resolved :class:`PlanSpec`, the
    converted matrix, the multiply closures and what observability needs
    to price it (the roofline ``model_s(k)`` closure, the measured build
    seconds). Immutable — :meth:`SparseOperator.swap` installs a whole
    plan in one reference assignment."""
    spec: PlanSpec
    label: str                   # e.g. "sellcs"
    matrix: object               # what the multiply executes against
    multiply: Callable           # X -> Y
    impl: str                    # resolved impl ("kernel"/"plain"/"ref")
    model_s: Callable            # k -> roofline seconds for one flush
    build_s: float               # measured convert seconds
    multiply_t: Optional[Callable] = None
                                 # X -> A^T X over the SAME converted
                                 #   matrix; every realized plan carries
                                 #   one, so rmatmul never rebuilds

    def labels(self, **extra) -> Dict[str, str]:
        """Canonical residual-ledger labels for this plan's knobs."""
        from repro_torch.obs.residuals import choice_labels
        return choice_labels(schedule="single", num_chunks=1,
                             mesh_shape=(1, 1), compact_x=None, **extra)


class OperatorStats:
    """Multiply/swap accounting, updated under the operator lock.
    ``multiplies`` counts SpMV-equivalents (served columns), the unit of
    the paper's break-even."""
    __slots__ = ("multiplies", "calls", "swaps", "last_swap_unix_s",
                 "sellcs_builds")

    def __init__(self):
        self.multiplies = 0
        self.calls = 0
        self.swaps = 0
        self.last_swap_unix_s: Optional[float] = None
        self.sellcs_builds = 0

    def __repr__(self):
        return (f"OperatorStats(multiplies={self.multiplies}, "
                f"calls={self.calls}, swaps={self.swaps}, "
                f"sellcs_builds={self.sellcs_builds})")


class SparseOperator:
    """Partition-once / multiply-many handle over one sparse matrix.

    ::

        op = SparseOperator.from_coo(coo, PlanSpec(algorithm="merge"))
        y = op.matmul(x)          # or: op @ x
        op.swap(PlanSpec(algorithm="sellcs"))   # atomic
        op.plan, op.spec, op.stats, op.shape

    The operator multiplies on the device its COO lives on.
    """

    def __init__(self, coo: COO, plan=None, *, impl: str = "auto",
                 k_hint: int = 32, num_spmvs: int = 1000):
        self._coo = coo
        self._mstats = matrix_stats(coo)
        self._impl = impl
        self._k_hint = max(int(k_hint), 1)
        self._num_spmvs = num_spmvs
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        self.stats = OperatorStats()
        if isinstance(plan, RealizedPlan):
            self._plan = plan
        else:
            self._plan = self.realize(plan or PlanSpec())

    @classmethod
    def from_coo(cls, coo: COO, plan=None, *, impl: str = "auto",
                 k_hint: int = 32, num_spmvs: int = 1000
                 ) -> "SparseOperator":
        """Build the handle and realize its initial plan. ``plan`` is a
        :class:`PlanSpec` (None = single device, format chosen by
        ``core.select`` for ``k_hint`` right-hand sides amortized over
        ``num_spmvs`` multiplies) or an already-built :class:`RealizedPlan`,
        installed as-is."""
        return cls(coo, plan, impl=impl, k_hint=k_hint,
                   num_spmvs=num_spmvs)

    # -- read side ---------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return self._coo.shape

    @property
    def device(self) -> torch.device:
        return self._coo.device

    @property
    def plan(self) -> RealizedPlan:
        return self._plan

    @property
    def spec(self) -> PlanSpec:
        return self._plan.spec

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``Y = A @ X`` under the currently installed plan, read once."""
        rp = self._plan
        y = rp.multiply(x)
        k = 1 if x.ndim == 1 else int(x.shape[1])
        with self._lock:
            self.stats.calls += 1
            self.stats.multiplies += k
        return y

    __matmul__ = matmul

    def rmatmul(self, x: torch.Tensor) -> torch.Tensor:
        """``Y = A^T X`` (``X: [m, k]``, ``Y: [n, k]``) under the SAME
        installed plan: the transpose multiplies the stored stream with
        the roles of the row permutation and the column scatter
        exchanged, so no second format exists to drift out of sync with
        the forward one. Counts toward the same break-even
        ``multiplies``."""
        rp = self._plan
        if rp.multiply_t is None:
            raise ValueError(
                f"plan {rp.label!r} carries no transpose multiply; "
                "re-realize it (pre-transpose plans cannot rmatmul)")
        y = rp.multiply_t(x)
        k = 1 if x.ndim == 1 else int(x.shape[1])
        with self._lock:
            self.stats.calls += 1
            self.stats.multiplies += k
        return y

    @property
    def T(self) -> "TransposedOperator":
        """Transpose view: ``op.T @ x`` is ``op.rmatmul(x)``. A view, not
        a copy — it reads the operator's current plan at each multiply, so
        swaps show through and ``op.T.T is op``."""
        return TransposedOperator(self)

    # -- write side --------------------------------------------------------
    def realize(self, spec: PlanSpec) -> RealizedPlan:
        """Build an executable plan for ``spec`` WITHOUT installing it —
        safe to call from a background thread while ``matmul`` traffic
        runs on the current plan."""
        with self._build_lock:
            spec = spec.canonical()
            if spec.num_devices != 1:
                raise NotImplementedError(MESH_SLICE)
            plan = _realize_single(self._coo, self._mstats, spec,
                                   impl=self._impl, k_hint=self._k_hint,
                                   num_spmvs=self._num_spmvs)
            if plan.spec.algorithm == "sellcs":
                with self._lock:
                    self.stats.sellcs_builds += 1
            return plan

    def swap(self, new_plan) -> RealizedPlan:
        """Atomically install ``new_plan`` (a :class:`RealizedPlan`, or a
        :class:`PlanSpec` realized on the spot); returns it."""
        if isinstance(new_plan, PlanSpec):
            new_plan = self.realize(new_plan)
        if not isinstance(new_plan, RealizedPlan):
            raise TypeError("swap takes a RealizedPlan or PlanSpec, got "
                            f"{type(new_plan).__name__}")
        with self._lock:
            self._plan = new_plan
            self.stats.swaps += 1
            self.stats.last_swap_unix_s = time.time()
        return new_plan

    def shrink_to(self, devices, *, num_chunks=None):
        raise NotImplementedError(MESH_SLICE)


class TransposedOperator:
    """Zero-copy transpose view over a :class:`SparseOperator` — the
    ``op.T`` surface. Shares the parent's plan (and so its swap atomicity
    and break-even accounting); only the multiply direction and the
    reported shape flip."""

    def __init__(self, base: SparseOperator):
        self._base = base

    @property
    def shape(self) -> Tuple[int, int]:
        m, n = self._base.shape
        return n, m

    @property
    def plan(self) -> RealizedPlan:
        return self._base.plan

    @property
    def T(self) -> SparseOperator:
        return self._base

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        return self._base.rmatmul(x)

    __matmul__ = matmul

    def rmatmul(self, x: torch.Tensor) -> torch.Tensor:
        return self._base.matmul(x)


class _SparseMatmul(torch.autograd.Function):
    """Forward ``op.matmul(x)``; backward ``op.rmatmul(g)`` read from the
    plan installed at backward time. ``op`` is not differentiated."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return op.matmul(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.op.rmatmul(g), None


def sparse_matmul(op, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``Y = op @ x`` for 1-D or 2-D ``x``: the forward
    multiply runs through the operator's realized plan and the backward
    through the SAME plan's transpose multiply (``d loss/d x =
    op.rmatmul(g)``, ``A^T g`` over the one stored stream). ``op`` is a
    :class:`SparseOperator` or its :class:`TransposedOperator` view."""
    return _SparseMatmul.apply(x, op)


def _realize_single(coo: COO, stats: MatrixStats, spec: PlanSpec, *,
                    impl: str, k_hint: int, num_spmvs: int) -> RealizedPlan:
    from repro_torch.core.convert import convert
    from repro_torch.kernels.merge_spmv import cached_merge_plan
    from repro_torch.roofline import spmm_distributed_time
    from repro_torch.spmm import resolve_impl
    from repro_torch.spmm.sellcs import SellCS
    t0 = time.perf_counter()
    algo = spec.algorithm or select(stats, MachineSpec(1),
                                    num_spmvs=num_spmvs, k=k_hint)
    structure = spec.structure or "general"
    if structure == "symmetric" and algo != "sellcs":
        raise ValueError(
            "structure='symmetric' (one-triangle storage) is executable "
            f"only on the SELL-C-σ stream, not {algo!r}")
    impl_r = resolve_impl(impl, coo.device)
    if algo == "sellcs":
        mat = convert(coo, algo, structure=structure)
    else:
        mat = convert(coo, algo)
    if isinstance(mat, BlockedSparse):
        # no kernel multiplies the blocked storage itself (its compute
        # form is TiledSparse): the plan multiplies through its oracle,
        # as the reference does off the TPU
        impl_r = "ref"
    if isinstance(mat, CSR) and impl_r != "ref":
        # every CSR multiply runs the merge path: its plan is part of the
        # conversion, built here so that no served flush builds it
        cached_merge_plan(mat)
    mat_bytes = _matrix_bytes_est(algo, stats)

    def multiply(X):
        from repro_torch.spmm import spmm
        return spmm(mat, X, impl=impl_r)

    if isinstance(mat, SellCS):
        def multiply_t(X):
            from repro_torch.spmm import spmm
            return spmm(mat, X, impl=impl_r, op="T")
    else:
        # formats without a transpose path multiply the immutable COO
        # source the operator already owns — correct, just unamortized
        def multiply_t(X):
            from repro_torch.spmm.reference import spmm_ref
            return spmm_ref(coo, X, op="T")

    def model_s(k):
        # the distributed model at P=1 degenerates to the plain
        # streaming-bytes roofline for this format
        return spmm_distributed_time(stats.m, stats.n, k, 1, "row",
                                     matrix_bytes=mat_bytes,
                                     max_row_nnz=stats.max_row_nnz,
                                     nnz=stats.nnz, structure=structure)

    resolved = dataclasses.replace(spec, algorithm=algo, structure=structure)
    return RealizedPlan(resolved, algo, mat, multiply, impl_r, model_s,
                        time.perf_counter() - t0, multiply_t=multiply_t)


__all__ = ["SparseOperator", "RealizedPlan", "OperatorStats", "PlanSpec",
           "TransposedOperator", "coo_fingerprint", "sparse_matmul"]
