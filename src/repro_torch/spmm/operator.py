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

A plan with ``num_devices > 1`` multiplies the SELL-C-σ stream over a
device mesh (``repro_torch.spmm.distributed``): the joint schedule × mesh
× chunks × compact-X × gather choice comes from
``core.select_distributed`` under the spec's pins, and the mesh from
``repro_torch.launch.mesh`` over the operator's ``devices`` (default: the
machine's CUDA cards; a list may repeat a device). Convert-time artifacts
are cached per operator (the SELL-C-σ stream and each base partition),
so a swap that changes only the chunk depth re-bakes the span plan
(``rechunk_sellcs``) instead of repartitioning, and ``shrink_to``
re-deals the current partition over fewer devices without converting.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import COO, CSR, BlockedSparse
from repro_torch.core.selector import (MachineSpec, MatrixStats, PlanSpec,
                                       _matrix_bytes_est, matrix_stats,
                                       select, select_distributed)

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


def _pick_chunk(m: int, num_devices: int, default: int = 128) -> int:
    """Largest power-of-two slice height <= default that still gives every
    device at least one slice to own (small matrices on big meshes)."""
    c = default
    while c > 8 and -(-m // c) < num_devices:
        c //= 2
    return c


class RealizedPlan(NamedTuple):
    """One executable multiply plan: the resolved :class:`PlanSpec`, the
    converted matrix (a partitioned ``ShardedSellCS`` on a mesh), the
    multiply closures and what observability needs to price it (the
    roofline ``model_s(k)`` closure, the measured build seconds).
    Immutable — :meth:`SparseOperator.swap` installs a whole plan in one
    reference assignment."""
    spec: PlanSpec
    label: str                   # e.g. "sellcs+merge@4dev/chunks=2"
    matrix: object               # what the multiply executes against
    multiply: Callable           # X -> Y
    impl: str                    # resolved impl ("kernel"/"plain"/"ref")
    model_s: Callable            # k -> roofline seconds for one flush
    build_s: float               # measured convert (+ partition) seconds
    multiply_t: Optional[Callable] = None
                                 # X -> A^T X over the SAME converted
                                 #   matrix; every realized plan carries
                                 #   one, so rmatmul never rebuilds
    local_matrix: object = None  # the single-device stream a mesh plan was
                                 #   partitioned from (sequential baselines
                                 #   and oracles); None = ``matrix``
    n_touched: Optional[float] = None
                                 # mean touched columns per shard of the
                                 #   map the multiply gathers through
                                 #   (compact_x plans only)

    @property
    def single(self) -> object:
        """The single-device form of the plan's matrix."""
        return self.matrix if self.local_matrix is None else \
            self.local_matrix

    def labels(self, **extra) -> Dict[str, str]:
        """Canonical residual-ledger labels for this plan's knobs."""
        from repro_torch.obs.residuals import choice_labels
        sp = self.spec
        if (sp.num_devices or 1) > 1:
            return choice_labels(schedule=sp.schedule,
                                 num_chunks=sp.num_chunks or 1,
                                 mesh_shape=sp.mesh_shape,
                                 compact_x=bool(sp.compact_x),
                                 structure=sp.structure or "general",
                                 gather=((sp.gather or "upfront")
                                         if sp.compact_x else None),
                                 **extra)
        return choice_labels(schedule="single", num_chunks=1,
                             mesh_shape=(1, 1), compact_x=None, **extra)


class OperatorStats:
    """Multiply/swap accounting, updated under the operator lock.
    ``multiplies`` counts SpMV-equivalents (served columns), the unit of
    the paper's break-even; ``sellcs_builds``/``partition_builds`` count
    conversions and device deals paid, ``plan_cache_hits`` their
    reuses."""
    __slots__ = ("multiplies", "calls", "swaps", "last_swap_unix_s",
                 "sellcs_builds", "partition_builds", "plan_cache_hits")

    def __init__(self):
        self.multiplies = 0
        self.calls = 0
        self.swaps = 0
        self.last_swap_unix_s: Optional[float] = None
        self.sellcs_builds = 0
        self.partition_builds = 0
        self.plan_cache_hits = 0

    def __repr__(self):
        return (f"OperatorStats(multiplies={self.multiplies}, "
                f"calls={self.calls}, swaps={self.swaps}, "
                f"sellcs_builds={self.sellcs_builds}, "
                f"partition_builds={self.partition_builds}, "
                f"plan_cache_hits={self.plan_cache_hits})")


class _PlanCache:
    """Per-operator convert-time artifacts: the SELL-C-σ stream per
    (slice height, structure) and each base partition per (schedule,
    P_data, compact_x, structure)."""

    def __init__(self):
        self.sellcs: Dict[Tuple[int, str], object] = {}
        self.partitions: Dict[Tuple[str, int, bool, str], object] = {}


class SparseOperator:
    """Partition-once / multiply-many handle over one sparse matrix.

    ::

        op = SparseOperator.from_coo(coo, PlanSpec(algorithm="merge"))
        y = op.matmul(x)          # or: op @ x
        op.swap(PlanSpec(algorithm="sellcs"))   # atomic
        op.swap(PlanSpec(num_devices=4, num_chunks=2))   # a mesh plan
        op.plan, op.spec, op.stats, op.shape

    A single-device plan multiplies on the device its COO lives on; a mesh
    plan over ``devices`` (default: the machine's first CUDA cards; a list
    may repeat one device), with answers on the COO's device.
    """

    def __init__(self, coo: COO, plan=None, *, impl: str = "auto",
                 k_hint: int = 32, num_spmvs: int = 1000,
                 devices: Optional[Sequence] = None):
        self._coo = coo
        self._mstats = matrix_stats(coo)
        self._impl = impl
        self._k_hint = max(int(k_hint), 1)
        self._num_spmvs = num_spmvs
        self._devices = None if devices is None else list(devices)
        self._cache = _PlanCache()
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        self.stats = OperatorStats()
        if isinstance(plan, RealizedPlan):
            self._plan = plan
        else:
            self._plan = self.realize(plan or PlanSpec())

    @classmethod
    def from_coo(cls, coo: COO, plan=None, *, impl: str = "auto",
                 k_hint: int = 32, num_spmvs: int = 1000,
                 devices: Optional[Sequence] = None) -> "SparseOperator":
        """Build the handle and realize its initial plan. ``plan`` is a
        :class:`PlanSpec` (None = single device, format chosen by
        ``core.select`` for ``k_hint`` right-hand sides amortized over
        ``num_spmvs`` multiplies) or an already-built :class:`RealizedPlan`,
        installed as-is. ``devices`` are the mesh plans' devices."""
        return cls(coo, plan, impl=impl, k_hint=k_hint,
                   num_spmvs=num_spmvs, devices=devices)

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
    def realize(self, spec: PlanSpec, feedback=None) -> RealizedPlan:
        """Build an executable plan for ``spec`` WITHOUT installing it —
        safe to call from a background thread while ``matmul`` traffic
        runs on the current plan. ``feedback`` (a ``ResidualLedger``)
        reaches ``select_distributed`` for a mesh plan's unpinned knobs."""
        with self._build_lock:
            spec = spec.canonical()
            if spec.num_devices != 1:
                return _realize_mesh(self._coo, self._mstats, spec,
                                     impl=self._impl, k_hint=self._k_hint,
                                     num_spmvs=self._num_spmvs,
                                     feedback=feedback, cache=self._cache,
                                     devices=self._devices,
                                     op_stats=self.stats, lock=self._lock)
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

    def shrink_to(self, devices: Sequence, *,
                  num_chunks: Optional[int] = None) -> RealizedPlan:
        """Device-loss path: re-deal the current mesh plan's width-row
        stream over ``devices`` (the survivors) and install the shrunken
        plan. The stream is rebuilt from the shards (``redeal_sellcs``:
        no σ-sort, no conversion); the model axis keeps its width and the
        data axis absorbs the loss. Returns the installed plan."""
        from repro_torch.launch.mesh import make_spmm_mesh
        from repro_torch.spmm.distributed import redeal_sellcs
        rp = self._plan
        sp = rp.spec
        if (sp.num_devices or 1) <= 1:
            raise ValueError(
                "shrink_to needs a distributed plan; the current plan is "
                f"single-device ({rp.label!r})")
        devices = list(devices)
        _, pm = sp.mesh_shape
        pd = len(devices) // pm
        if pd < 1:
            raise ValueError("fewer devices than one model replica")
        nc = int(num_chunks) if num_chunks is not None else (sp.num_chunks
                                                            or 1)
        t0 = time.perf_counter()
        with self._build_lock:
            mesh = make_spmm_mesh((pd, pm), devices=devices[:pd * pm])
            sharded = redeal_sellcs(rp.matrix, pd, num_chunks=nc,
                                    devices=_data_devices(mesh))
            compact = bool(sp.compact_x)
            # the survivors' partition replaces the stale artifact, so a
            # later chunks-only swap re-deals from the live device count
            self._cache.partitions[(sp.schedule, pd, compact,
                                    sp.structure or "general")] = sharded
            with self._lock:
                self.stats.partition_builds += 1
            plan = _mesh_plan(sharded, rp.single, self._mstats, mesh,
                              schedule=sp.schedule, chunks=nc, pd=pd, pm=pm,
                              compact=compact, impl_r=rp.impl, t0=t0,
                              gather=((sp.gather or "upfront") if compact
                                      else "upfront"))
        return self.swap(plan)


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


def _data_devices(mesh):
    """The device of each data shard (model column 0), where its
    partition lives."""
    grid = mesh.devices
    return list(grid if grid.ndim == 1 else grid[:, 0])


def _realize_mesh(coo: COO, stats: MatrixStats, spec: PlanSpec, *, impl,
                  k_hint, num_spmvs, feedback, cache: _PlanCache, devices,
                  op_stats: OperatorStats, lock) -> RealizedPlan:
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.spmm import resolve_impl
    from repro_torch.spmm.distributed import (partition_sellcs_nnz,
                                              partition_sellcs_rows,
                                              rechunk_sellcs)
    from repro_torch.spmm.sellcs import coo_to_sellcs
    t0 = time.perf_counter()
    if spec.algorithm not in (None, "sellcs"):
        raise ValueError(
            f"algorithm {spec.algorithm!r} cannot run on a mesh: the "
            "distributed multiply executes the SELL-C-σ slice stream "
            "(repro_torch.spmm.distributed)")
    choice = select_distributed(
        stats, k=k_hint, num_spmvs=num_spmvs,
        spec=dataclasses.replace(spec, algorithm="sellcs"),
        feedback=feedback)
    schedule, chunks = choice.schedule, choice.num_chunks
    (pd, pm), compact = choice.mesh_shape, choice.compact_x
    structure = choice.structure
    gather = choice.gather if compact else "upfront"
    mesh = make_spmm_mesh((pd, pm), devices=devices)
    c = _pick_chunk(stats.m, pd)
    skey = (c, structure)
    sc = cache.sellcs.get(skey)
    if sc is None:
        sc = cache.sellcs.setdefault(
            skey, coo_to_sellcs(coo, c=c, structure=structure))
        with lock:
            op_stats.sellcs_builds += 1
    else:
        with lock:
            op_stats.plan_cache_hits += 1
    key = (schedule, pd, compact, structure)
    base = cache.partitions.get(key)
    if base is None:
        part = (partition_sellcs_rows if schedule == "row"
                else partition_sellcs_nnz)
        base = cache.partitions.setdefault(
            key, part(sc, pd, compact_x=compact,
                      devices=_data_devices(mesh)))
        with lock:
            op_stats.partition_builds += 1
    else:
        with lock:
            op_stats.plan_cache_hits += 1
    # partition reuse across swaps: only the span plan is re-baked
    sharded = base if schedule == "row" else rechunk_sellcs(base, chunks)
    impl_r = resolve_impl(impl, mesh.devices.flat[0])
    return _mesh_plan(sharded, sc, stats, mesh, schedule=schedule,
                      chunks=chunks, pd=pd, pm=pm, compact=compact,
                      impl_r=impl_r, t0=t0, gather=gather)


def _mesh_plan(sharded, sc, stats: MatrixStats, mesh, *, schedule, chunks,
               pd, pm, compact, impl_r, t0, gather="upfront"
               ) -> RealizedPlan:
    """Close a :class:`RealizedPlan` over a partitioned stream — the
    shared tail of the convert-time realize and ``shrink_to``."""
    from repro_torch.roofline import spmm_distributed_time
    from repro_torch.spmm.distributed import (spmm_merge_distributed,
                                              spmm_row_distributed)
    structure = sharded.structure
    gx = gather if compact else None
    if schedule == "row":
        def multiply(X, op="N"):
            return spmm_row_distributed(sharded, X, mesh, impl=impl_r,
                                        gather=gx, op=op)
    else:
        def multiply(X, op="N"):
            return spmm_merge_distributed(sharded, X, mesh, impl=impl_r,
                                          num_chunks=chunks, gather=gx,
                                          op=op)
    mesh_tag = f"{pd}x{pm}mesh" if pm > 1 else f"{pd}dev"
    cx_tag = "/cx=on" if compact else ""
    gx_tag = f"/gx={gather}" if compact and gather != "upfront" else ""
    sym_tag = "/sym" if structure == "symmetric" else ""
    if schedule == "row":
        label = f"sellcs+row@{mesh_tag}{cx_tag}{gx_tag}{sym_tag}"
    else:
        label = (f"sellcs+merge@{mesh_tag}/chunks={chunks}"
                 f"{cx_tag}{gx_tag}{sym_tag}")
    # price the gather with the map the multiply executes (the chunk
    # plan's re-dealt map when chunked)
    n_touched = None
    if compact:
        nt_src = (sharded.chunk_plan[3]
                  if sharded.chunk_plan is not None else sharded.n_touched)
        n_touched = float(nt_src.double().mean())
    sellcs_bytes = _matrix_bytes_est("sellcs", stats)

    def model_s(k):
        return spmm_distributed_time(
            stats.m, stats.n, k, pd, schedule, matrix_bytes=sellcs_bytes,
            max_row_nnz=stats.max_row_nnz, num_chunks=chunks,
            model_devices=pm, compact_x=compact, n_touched=n_touched,
            nnz=stats.nnz, structure=structure,
            gather=gather if compact else "upfront")

    resolved = PlanSpec(num_devices=pd * pm, mesh_shape=(pd, pm),
                        num_chunks=chunks, compact_x=compact,
                        schedule=schedule, algorithm="sellcs",
                        structure=structure,
                        gather=gather if compact else None)
    return RealizedPlan(resolved, label, sharded, multiply, impl_r, model_s,
                        time.perf_counter() - t0,
                        multiply_t=lambda X: multiply(X, op="T"),
                        local_matrix=sc, n_touched=n_touched)


__all__ = ["SparseOperator", "RealizedPlan", "OperatorStats", "PlanSpec",
           "TransposedOperator", "coo_fingerprint", "sparse_matmul"]
