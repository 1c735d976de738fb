"""Algorithm auto-selection — the paper's §7 decision procedure as code.

The paper's conclusion: the best algorithm depends on (a) matrix density,
(b) row-length skew (the mawi case), (c) machine topology (UMA vs NUMA), and
(d) how many SpMVs will amortize the conversion cost (the "472
multiplications" rule for BCOHC on Sapphire Rapids).

GPU translation: "UMA" = one card; "NUMA" = several cards joined by
NVLink, where y-locality (static row bands, no collectives on y) matters
the way socket-locality did on CPU. This slice executes single-device
plans only; ``select_distributed`` is carried whole because the serve
migration controller scores its target with it even on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from .formats import COO


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    m: int
    n: int
    nnz: int
    max_row_nnz: int
    row_var: float
    symmetric: bool = False    # A == A^T (pattern and values)

    @property
    def density(self) -> float:
        return self.nnz / max(self.m * self.n, 1)

    @property
    def has_dense_row(self) -> bool:
        """mawi_0130-style pathology: one row holding a large fraction of all
        nonzeros (paper Table 6.3)."""
        return self.max_row_nnz > max(0.01 * self.nnz, 10 * self.nnz /
                                      max(self.m, 1))


def _is_symmetric(coo: COO) -> bool:
    """Host-side ``A == A^T`` check (pattern exact after summing duplicate
    coordinates, values to fp-reassociation tolerance) — the same predicate
    ``coo_to_sellcs(structure='symmetric')`` enforces, so a True here means
    one-triangle storage is actually convertible."""
    m, n = coo.shape
    if m != n:
        return False
    r, c, v = coo.host_triplets()
    rows = np.asarray(r, np.int64)
    cols = np.asarray(c, np.int64)
    if rows.size == 0:
        return True
    vals = np.asarray(v, np.float64)

    def dedup(keys, v):
        order = np.argsort(keys, kind="stable")
        kk, vv = keys[order], v[order]
        uk, start = np.unique(kk, return_index=True)
        return uk, np.add.reduceat(vv, start)

    ka, va = dedup(rows * n + cols, vals)
    kb, vb = dedup(cols * n + rows, vals)
    if ka.shape != kb.shape or not np.array_equal(ka, kb):
        return False
    scale = float(np.abs(va).max()) if va.size else 1.0
    return bool(np.allclose(va, vb, rtol=1e-6, atol=1e-9 * max(scale, 1.0)))


def matrix_stats(coo: COO) -> MatrixStats:
    rows = np.asarray(coo.host_triplets()[0])
    counts = np.bincount(rows, minlength=coo.shape[0]) if rows.size else \
        np.zeros(coo.shape[0], np.int64)
    return MatrixStats(
        m=coo.shape[0], n=coo.shape[1], nnz=int(rows.size),
        max_row_nnz=int(counts.max()) if counts.size else 0,
        row_var=float(counts.var()) if counts.size else 0.0,
        symmetric=_is_symmetric(coo))


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    num_devices: int = 1          # mesh size; 1 == "UMA"
    fast_memory: bool = True      # HBM-class vs DDR-class bandwidth

    @property
    def numa_like(self) -> bool:
        return self.num_devices > 1


# Relative conversion cost in units of ParCRS SpMVs, averaged from the
# paper's Tables 6.4/6.5 (Sapphire Rapids column; used as priors when no
# measured table is supplied).
DEFAULT_CONVERSION_COST: Dict[str, float] = {
    "parcrs": 100.0, "merge": 98.0, "csb": 95.0, "csbh": 370.0,
    "bcoh": 230.0, "bcohc": 225.0, "bcohch": 520.0, "bcohchp": 520.0,
    "mergeb": 85.0, "mergebh": 480.0,
}

# Relative SpMV throughput priors (higher is better), from Tables 6.1/6.2:
# {(numa_like, low_density): {algo: speedup}}
DEFAULT_THROUGHPUT: Dict[tuple, Dict[str, float]] = {
    (True, True): {"parcrs": 42.2, "merge": 43.6, "csb": 29.4, "csbh": 30.4,
                   "bcoh": 45.8, "bcohc": 49.6, "bcohch": 49.7,
                   "bcohchp": 26.7, "mergeb": 22.6, "mergebh": 23.3},
    (True, False): {"parcrs": 55.2, "merge": 71.3, "csb": 33.7, "csbh": 37.1,
                    "bcoh": 59.5, "bcohc": 81.9, "bcohch": 84.6,
                    "bcohchp": 72.1, "mergeb": 33.3, "mergebh": 37.1},
    (False, True): {"parcrs": 18.8, "merge": 18.0, "csb": 18.9, "csbh": 19.1,
                    "bcoh": 13.7, "bcohc": 14.5, "bcohch": 14.2,
                    "bcohchp": 11.2, "mergeb": 15.0, "mergebh": 15.6},
    (False, False): {"parcrs": 25.8, "merge": 24.4, "csb": 20.5, "csbh": 21.3,
                     "bcoh": 18.0, "bcohc": 24.4, "bcohch": 25.6,
                     "bcohchp": 23.6, "mergeb": 14.8, "mergebh": 17.3},
}

# Algorithms able to split a single row across workers (paper Table 6.3).
ROW_SPLITTING = ("merge", "csb", "csbh")

# The serving path's zero-conversion start: merge-path CSR costs one
# coo_to_csr row-sort, so a matrix that never reaches break-even never
# pays for a format it did not need (launch.serve --migrate).
ZERO_CONVERSION_ALGO = "merge"

DENSITY_THRESHOLD = 1e-6   # the paper's low/high density split


def amortized_cost(algo: str, num_spmvs: int, *, numa_like: bool,
                   low_density: bool,
                   conversion_cost: Optional[Dict[str, float]] = None,
                   throughput: Optional[Dict[str, float]] = None) -> float:
    """Total cost of `num_spmvs` multiplications + one conversion, in units
    of ParCRS SpMV time (the paper's break-even arithmetic)."""
    conv = (conversion_cost or DEFAULT_CONVERSION_COST)[algo]
    thr = (throughput or DEFAULT_THROUGHPUT[(numa_like, low_density)])
    per_spmv = thr["parcrs"] / thr[algo]      # time relative to ParCRS
    return conv + num_spmvs * per_spmv


def break_even_spmvs(algo: str, *, numa_like: bool, low_density: bool,
                     baseline: str = "parcrs", **kw) -> float:
    """How many SpMVs before `algo` beats `baseline` including conversion
    (e.g. ~472 for bcohc on a NUMA/high-density setting in the paper)."""
    thr = kw.get("throughput") or DEFAULT_THROUGHPUT[(numa_like, low_density)]
    conv = kw.get("conversion_cost") or DEFAULT_CONVERSION_COST
    gain = thr["parcrs"] / thr[baseline] - thr["parcrs"] / thr[algo]
    if gain <= 0:
        return math.inf
    return max((conv[algo] - conv[baseline]) / gain, 0.0)


def select_algorithm(stats: MatrixStats, machine: MachineSpec,
                     num_spmvs: int = 1000,
                     conversion_cost: Optional[Dict[str, float]] = None,
                     throughput: Optional[Dict[str, float]] = None) -> str:
    """The §7 decision procedure."""
    low = stats.density < DENSITY_THRESHOLD
    key = (machine.numa_like, low)
    thr = throughput or DEFAULT_THROUGHPUT[key]
    candidates = list(thr)
    if stats.has_dense_row:
        # only row-splitting algorithms survive the mawi pathology
        candidates = [a for a in candidates if a in ROW_SPLITTING]
    best, best_cost = None, math.inf
    for algo in candidates:
        cost = amortized_cost(algo, num_spmvs, numa_like=machine.numa_like,
                              low_density=low,
                              conversion_cost=conversion_cost,
                              throughput=thr)
        if cost < best_cost:
            best, best_cost = algo, cost
    return best


# --------------------------------------------------------------------------
# Multi-RHS (SpMM) extension of the decision procedure — repro_torch.spmm
# --------------------------------------------------------------------------
# Priors for SELL-C-σ (repro_torch.spmm.sellcs), which the paper does not measure:
# conversion is a σ-window counting sort (CSB-like cost); throughput sits at
# the CSB level, with a bonus on skewed matrices where the row sorting
# removes the slice-padding/imbalance that penalizes the other formats.
# These are offline priors only — autotune(k=...) measures the real thing.
SELLCS_CONVERSION_COST = 95.0
SELLCS_SKEW_BONUS = 1.3
SELLCS_BASE_BONUS = 1.05

_VVAR_SKEW_THRESHOLD = 10.0     # squared coeff. of variation of row lengths


def _row_skew(stats: MatrixStats) -> float:
    mean = stats.nnz / max(stats.m, 1)
    return stats.row_var / max(mean * mean, 1e-12)


def _augment_sellcs(thr: Dict[str, float], conv: Dict[str, float],
                    stats: MatrixStats) -> Tuple[Dict[str, float],
                                                 Dict[str, float]]:
    """Extend a (throughput, conversion) table pair — the paper priors or a
    caller-measured table — with the SELL-C-σ entries: throughput at the
    CSB level with a skew bonus (the σ-sort removes the slice-padding
    imbalance that penalizes the other formats on skewed rows), conversion
    at the counting-sort cost. Shared by :func:`select`,
    :func:`select_distributed` and the serve migration controller's
    cold-start break-even so all three price the format identically.
    Mutates and returns ``(thr, conv)``."""
    if "sellcs" not in thr:
        skewed = stats.has_dense_row or _row_skew(stats) > _VVAR_SKEW_THRESHOLD
        bonus = SELLCS_SKEW_BONUS if skewed else SELLCS_BASE_BONUS
        thr["sellcs"] = thr.get("csb", min(thr.values())) * bonus
    conv.setdefault("sellcs", SELLCS_CONVERSION_COST)
    return thr, conv


def _matrix_bytes_est(algo: str, stats: MatrixStats,
                      dtype_bytes: int = 4) -> float:
    """Streamed matrix footprint of one multiply, per format family."""
    from repro_torch.roofline.analysis import csr_stream_bytes
    nz = max(stats.nnz, 1)
    if algo in ("parcrs", "merge"):
        return csr_stream_bytes(nz, stats.m, dtype_bytes)
    if algo == "sellcs":
        # σ-sorting bounds slice padding; model residual fill-in by skew
        pad = 1.0 + min(0.25 * _row_skew(stats), 1.0)
        return nz * (4 + dtype_bytes) * pad
    # blocked families: 16+16 packed indices + block structure
    return nz * (4 + dtype_bytes)


def spmm_cost_scale(algo: str, stats: MatrixStats, k: int,
                    dtype_bytes: int = 4) -> float:
    """Cost of one k-RHS SpMM relative to one SpMV under the memory-bound
    roofline: the matrix stream is paid once, the vector slabs k times.
    Equals 1 at k = 1; grows sublinearly in k (that is the whole point)."""
    mat = _matrix_bytes_est(algo, stats, dtype_bytes)
    vec = (stats.m + stats.n) * dtype_bytes
    return (mat + k * vec) / (mat + vec)


def select(stats: MatrixStats, machine: Optional[MachineSpec] = None,
           num_spmvs: int = 1000, k: int = 1,
           conversion_cost: Optional[Dict[str, float]] = None,
           throughput: Optional[Dict[str, float]] = None, *,
           num_devices: Optional[int] = None) -> str:
    """k-aware decision procedure: which format should multiply ``A`` by a
    ``[n, k]`` block ``num_spmvs`` times?

    ``k = 1`` IS ``select_algorithm`` — identical candidates, identical
    economics. For ``k > 1`` the per-multiply term is rescaled by
    :func:`spmm_cost_scale` (the matrix stream amortizes over k columns)
    and SELL-C-σ joins the candidate set; on dense-row pathologies it
    survives alongside the row-splitting algorithms because the σ-sort plus
    slice padding turns the dense row into uniform work quanta.

    Passing ``num_devices`` switches to the *joint* (format × schedule × k)
    scoring of :func:`select_distributed` — format and cross-device
    schedule must be chosen together (replicated-X bytes and the merge
    psum both enter the modelled intensity), and the paper's NUMA prior
    alone cannot see either. A caller-measured ``throughput`` table is
    threaded through (it rescales each format's single-device multiply
    exactly as in :func:`amortized_cost`; the traffic model then carries it
    across the mesh). The return value stays a format name; call
    ``select_distributed`` directly when the schedule, mesh shape or
    chunking depth is needed too.
    """
    if num_devices is not None and num_devices > 1:
        return select_distributed(
            stats, k=k, num_devices=num_devices, num_spmvs=num_spmvs,
            conversion_cost=conversion_cost,
            throughput=throughput).algorithm
    if machine is None:
        machine = MachineSpec(num_devices or 1)
    if k <= 1:
        return select_algorithm(stats, machine, num_spmvs,
                                conversion_cost=conversion_cost,
                                throughput=throughput)
    low = stats.density < DENSITY_THRESHOLD
    thr = dict(throughput or DEFAULT_THROUGHPUT[(machine.numa_like, low)])
    conv = dict(conversion_cost or DEFAULT_CONVERSION_COST)
    _augment_sellcs(thr, conv, stats)
    candidates = list(thr)
    if stats.has_dense_row:
        candidates = [a for a in candidates
                      if a in ROW_SPLITTING or a == "sellcs"]
    best, best_cost = None, math.inf
    for algo in candidates:
        per_spmv = thr["parcrs"] / thr[algo]
        cost = conv[algo] + num_spmvs * per_spmv * spmm_cost_scale(
            algo, stats, k)
        if cost < best_cost:
            best, best_cost = algo, cost
    return best


# --------------------------------------------------------------------------
# Distributed extension:
# the (format × schedule × k × mesh shape × chunks) grid
# --------------------------------------------------------------------------
SCHEDULES = ("row", "merge")

# Candidate psum pipelining depths for the "merge" schedule (1 = the
# monolithic fixup). "row" has no collective, so its depth is always 1.
CHUNK_CANDIDATES = (1, 2, 4, 8)

# Candidate compact-X gather schedules (the reference's distributed GATHER_MODES):
# "upfront" materializes the slab ahead of the mesh region, "overlap" hides
# per-span slab rebuilds under the chunked merge span loop, "fused" rides
# col_map on the kernel's scalar prefetch. Executable only with
# compact_x=True on the SELL-C-σ stream.
GATHER_CANDIDATES = ("upfront", "overlap", "fused")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """One carrier for the distributed-plan knobs that
    :func:`select_distributed`, :func:`core.autotune.autotune`,
    :func:`distributed_schedule_grid` and ``launch.serve`` used to re-spell
    as separate ``(num_devices, mesh_shape, num_chunks, compact_x)``
    kwargs.

    ``None`` means "unpinned — let the traffic model sweep this axis";
    a set field pins it, exactly like the old per-function kwargs (which
    remain as thin shims over this). ``num_chunks = 0`` is accepted as a
    synonym for unpinned (the serve ``--chunks 0`` convention).
    ``schedule`` / ``algorithm`` pins restrict the grid the same way;
    they also let a fully resolved spec name one executable plan — the
    form :meth:`repro_torch.spmm.SparseOperator.swap` consumes.
    """
    num_devices: Optional[int] = None
    mesh_shape: Optional[Tuple[int, int]] = None
    num_chunks: Optional[int] = None
    compact_x: Optional[bool] = None
    schedule: Optional[str] = None
    algorithm: Optional[str] = None
    structure: Optional[str] = None     # "general" | "symmetric" | unpinned
    gather: Optional[str] = None        # "upfront"|"overlap"|"fused"|unpinned

    def canonical(self) -> "PlanSpec":
        """Validate and normalize: mesh factors must agree with
        ``num_devices`` (a set mesh implies it), ``num_chunks = 0`` maps
        to unpinned, an omitted device count means 1."""
        nd, mesh = self.num_devices, self.mesh_shape
        if mesh is not None:
            pd, pm = int(mesh[0]), int(mesh[1])
            if pd < 1 or pm < 1:
                raise ValueError(f"mesh_shape must be positive, got {mesh}")
            mesh = (pd, pm)
            if nd is None:
                nd = pd * pm
            elif int(nd) != pd * pm:
                raise ValueError(
                    f"mesh_shape {mesh} factors {pd * pm} devices but "
                    f"num_devices={nd}")
        nd = 1 if nd is None else int(nd)
        if nd < 1:
            raise ValueError(f"num_devices must be >= 1, got {nd}")
        nc = self.num_chunks
        if nc is not None:
            nc = int(nc)
            if nc == 0:
                nc = None
            elif nc < 0:
                raise ValueError(f"num_chunks must be >= 0, got {nc}")
        if self.schedule is not None and self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got "
                             f"{self.schedule!r}")
        if self.structure is not None and \
                self.structure not in ("general", "symmetric"):
            raise ValueError(f"structure must be 'general' or 'symmetric', "
                             f"got {self.structure!r}")
        if self.gather is not None and self.gather not in GATHER_CANDIDATES:
            raise ValueError(f"gather must be one of {GATHER_CANDIDATES}, "
                             f"got {self.gather!r}")
        if self.gather not in (None, "upfront") and self.compact_x is False:
            raise ValueError(f"gather={self.gather!r} needs compact_x — "
                             f"a replicated-X plan has no X gather to hide")
        return dataclasses.replace(self, num_devices=nd, mesh_shape=mesh,
                                   num_chunks=nc)


def mesh_factorizations(num_devices: int) -> list:
    """Every (P_data, P_model) factorization of ``num_devices``, pure-data
    first — ties in the scored grid then keep the 1-D mesh, which is the
    pre-2-D behavior."""
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    return [(num_devices // pm, pm) for pm in range(1, num_devices + 1)
            if num_devices % pm == 0]


def distributed_schedule_grid(num_devices: int = 1,
                              pinned_chunks: Optional[int] = None,
                              chunk_candidates: Tuple[int, ...] =
                              CHUNK_CANDIDATES,
                              pinned_mesh: Optional[Tuple[int, int]] = None,
                              spec: Optional[PlanSpec] = None
                              ) -> list:
    """The (schedule × mesh shape × psum-chunking) axes of the distributed
    grid, shared by :func:`select_distributed`, ``core.autotune`` and
    ``launch.serve`` so the merge-only chunk rule and the mesh sweep live
    in exactly one place. Entries are ``(schedule, num_chunks,
    (P_data, P_model))``: "merge" sweeps the pipelining depths (or a single
    pinned depth), "row" has no collective to chunk and always pairs with
    depth 1; the mesh axis sweeps every (P_data, P_model) factorization of
    ``num_devices`` unless ``pinned_mesh`` fixes one.

    ``spec`` carries every pin in one :class:`PlanSpec` (a set
    ``schedule`` restricts that axis too); the positional
    ``(num_devices, pinned_chunks, pinned_mesh)`` kwargs remain as thin
    shims over it — spec fields win where both are given."""
    schedules = SCHEDULES
    if spec is not None:
        spec = spec.canonical()
        num_devices = spec.num_devices
        if spec.num_chunks is not None:
            pinned_chunks = spec.num_chunks
        if spec.mesh_shape is not None:
            pinned_mesh = spec.mesh_shape
        if spec.schedule is not None:
            schedules = (spec.schedule,)
    if pinned_mesh is not None:
        pd, pm = int(pinned_mesh[0]), int(pinned_mesh[1])
        if pd < 1 or pm < 1:
            raise ValueError(f"pinned_mesh must be positive, got "
                             f"{pinned_mesh}")
        meshes = [(pd, pm)]
    else:
        meshes = mesh_factorizations(num_devices)
    grid = []
    for schedule in schedules:
        if schedule == "merge":
            chunks = ((int(pinned_chunks),) if pinned_chunks
                      else chunk_candidates)
        else:
            chunks = (1,)
        grid.extend((schedule, int(nc), mesh)
                    for mesh in meshes for nc in chunks)
    return grid

# Formats with an executable mesh multiply: "parcrs" drives the ShardedCOO
# path in core.distributed (its nonzero stream is the row-sorted COO both
# partitioners consume), "sellcs" the slice-stream path in
# the reference's spmm.distributed. Other paper families are deliberately absent —
# recommending a format the mesh cannot run is worse than a slightly
# coarser prior.
DISTRIBUTED_ALGOS = ("parcrs", "sellcs")


class DistributedChoice(NamedTuple):
    """Winner of the joint (format × schedule × mesh × chunks × compact ×
    structure × gather) grid. Unpacks like the old ``(format, schedule,
    num_chunks)`` triple with ``mesh_shape`` — the chosen (P_data, P_model)
    factorization — riding fourth, ``compact_x`` — whether the
    sparsity-aware X gather beats replication — fifth, ``structure`` —
    ``"symmetric"`` when one-triangle storage wins on a symmetric matrix —
    sixth, and ``gather`` — how the compact-X slab build is scheduled
    (up-front / overlapped with the span loop / fused into the kernel) —
    seventh."""
    algorithm: str
    schedule: str
    num_chunks: int
    mesh_shape: Tuple[int, int] = (1, 1)
    compact_x: bool = False
    structure: str = "general"
    gather: str = "upfront"


def select_distributed(stats: MatrixStats, *, k: int = 1,
                       num_devices: int = 1, num_spmvs: int = 1000,
                       conversion_cost: Optional[Dict[str, float]] = None,
                       dtype_bytes: int = 4,
                       chunk_candidates: Tuple[int, ...] = CHUNK_CANDIDATES,
                       mesh_shape: Optional[Tuple[int, int]] = None,
                       throughput: Optional[Dict[str, float]] = None,
                       spec: Optional[PlanSpec] = None,
                       feedback=None,
                       n_touched: Optional[float] = None
                       ) -> DistributedChoice:
    """Joint (format, cross-device schedule, mesh shape, psum chunking)
    choice for ``num_devices`` devices multiplying a ``[n, k]`` block
    ``num_spmvs`` times.

    Scored entirely with the ``repro_torch.roofline`` traffic model
    (:func:`repro_torch.roofline.analysis.spmm_distributed_time`): each
    candidate's per-multiply time counts its streamed matrix bytes
    (per-format footprint, dense-row imbalance for the "row" schedule),
    the replicated-X read, the shard-local vs full-partial Y write, and —
    for "merge" — the *exposed* psum seconds after pipelining the fixup
    into ``num_chunks`` spans (chunked collectives hide under the slice
    stream; each chunk pays a launch, so the optimum depth is finite).
    The mesh axis sweeps every (P_data, P_model) factorization of
    ``num_devices`` (``mesh_shape`` pins one): a ``model`` axis divides
    every k-proportional byte term by P_model at the cost of a shallower
    matrix-stream split, so it starts paying once k is large enough that
    X/Y/psum bytes dominate the stream. For the SELL-C-σ mesh format the
    grid additionally scores the sparsity-aware X gather
    (``compact_x=True``): the replicated-X term becomes nnz-proportional
    (:func:`repro_torch.roofline.analysis.spmm_touched_fraction`), so compaction
    wins exactly when the matrix's columns are sparse enough that a shard
    touches fewer than ``n`` of them — on near-dense columns the modelled
    terms tie and the strict comparison keeps replication (the gather
    would be a wash that still pays a col_map). Times are normalized to
    the single-device ParCRS stream so the paper's conversion-cost priors
    keep their units, then amortized exactly like :func:`amortized_cost`.

    A caller-measured ``throughput`` table (same schema as
    :func:`select_algorithm`'s) replaces the modelled single-device ratio
    between formats: per-multiply cost becomes ``thr["parcrs"] / thr[algo]``
    scaled by the *mesh ratio* of the traffic model — measured where a
    measurement exists, modelled only across the mesh the caller cannot
    run. Without it the model prices both axes alone.

    Returns a :class:`DistributedChoice`; ``num_devices = 1`` degrades to
    the single-device model where both schedules tie and "row" wins by
    order. The "row" schedule has no collective and always reports
    ``num_chunks = 1``.

    ``spec`` carries every pin in one :class:`PlanSpec` — the
    ``(num_devices, mesh_shape)`` kwargs remain as shims over it, and its
    ``algorithm`` / ``schedule`` / ``num_chunks`` / ``compact_x`` fields
    additionally restrict those axes. ``feedback`` is the online
    rescoring entry point: pass a ``repro_torch.obs.ResidualLedger`` (e.g. the
    live one ``launch.serve --migrate`` feeds between flushes) and each
    candidate's modelled seconds are multiplied by the ledger's
    geometric-mean observed/modeled residual for its labels before the
    argmin — measured reality outvotes the streaming-bytes story wherever
    a measurement exists, exactly as in ``autotune(feedback=)``.

    For SELL-C-σ compact candidates the grid also scores the gather
    schedule (:data:`GATHER_CANDIDATES`): the exposed-gather-seconds term
    (:func:`repro_torch.roofline.analysis.spmm_distributed_gather_s`) is fully
    paid up-front, partially hidden by the chunked span loop, or zero when
    fused into the kernel prefetch — strict-< keeps ``upfront`` whenever
    hiding buys nothing (row schedule, one chunk). ``n_touched`` is a
    measured per-shard mean touched-column count from a live plan (e.g.
    the serve path's ``chunk_plan``); without it the model falls back to
    the nnz-proportional bound.
    """
    from repro_torch.roofline.analysis import spmm_distributed_time
    if spec is not None:
        spec = spec.canonical()
        num_devices = spec.num_devices
        if spec.mesh_shape is not None:
            mesh_shape = spec.mesh_shape
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    conv = dict(conversion_cost or DEFAULT_CONVERSION_COST)
    thr = None
    if throughput is not None:
        thr = dict(throughput)
        _augment_sellcs(thr, conv, stats)
    else:
        conv.setdefault("sellcs", SELLCS_CONVERSION_COST)
    base_s = spmm_distributed_time(
        stats.m, stats.n, 1, 1, "row",
        matrix_bytes=_matrix_bytes_est("parcrs", stats, dtype_bytes),
        dtype_bytes=dtype_bytes)
    grid = distributed_schedule_grid(num_devices,
                                     chunk_candidates=chunk_candidates,
                                     pinned_mesh=mesh_shape, spec=spec)
    algos = DISTRIBUTED_ALGOS
    if spec is not None and spec.algorithm is not None:
        if spec.algorithm not in DISTRIBUTED_ALGOS:
            raise ValueError(
                f"algorithm {spec.algorithm!r} has no executable mesh "
                f"multiply; pin one of {DISTRIBUTED_ALGOS}")
        algos = (spec.algorithm,)
    if feedback is not None:
        from repro_torch.obs.residuals import choice_labels
    best, best_cost = None, math.inf
    for algo in algos:
        mat_bytes = _matrix_bytes_est(algo, stats, dtype_bytes)
        if thr is not None:
            # measured single-device multiply, carried across the mesh by
            # the model's (mesh time / single-device time) ratio per format
            algo_base_s = spmm_distributed_time(
                stats.m, stats.n, k, 1, "row", matrix_bytes=mat_bytes,
                dtype_bytes=dtype_bytes)
            measured = thr["parcrs"] / thr[algo] * spmm_cost_scale(
                algo, stats, k, dtype_bytes)
        # the compact-gather knob is executable only on the SELL-C-σ slice
        # stream; recommending it for a format that cannot run it would be
        # worse than a coarser score (same rule as DISTRIBUTED_ALGOS)
        compacts = (False, True) if algo == "sellcs" else (False,)
        if spec is not None and spec.compact_x is not None:
            compacts = ((spec.compact_x,) if algo == "sellcs" else (False,))
        # one-triangle storage is executable only on SELL-C-σ and only
        # convertible when the matrix actually satisfies A == A^T; the
        # general candidate is scored first so symmetry must strictly win
        structures = ("general",)
        if algo == "sellcs" and stats.symmetric:
            structures = ("general", "symmetric")
        if spec is not None and spec.structure is not None:
            structures = ((spec.structure,) if algo == "sellcs"
                          else ("general",))
        for schedule, nc, (pd, pm) in grid:
            for compact in compacts:
                # the gather schedule only exists where there is a gather:
                # compact SELL-C-σ. "upfront" is scored first so an
                # overlapped/fused candidate must strictly beat it.
                gathers = (GATHER_CANDIDATES
                           if compact and algo == "sellcs"
                           else ("upfront",))
                if spec is not None and spec.gather is not None:
                    gathers = ((spec.gather,)
                               if compact and algo == "sellcs"
                               else ("upfront",))
                for structure in structures:
                    for gmode in gathers:
                        sec = spmm_distributed_time(
                            stats.m, stats.n, k, pd, schedule,
                            matrix_bytes=mat_bytes, dtype_bytes=dtype_bytes,
                            max_row_nnz=stats.max_row_nnz, num_chunks=nc,
                            model_devices=pm, compact_x=compact,
                            nnz=stats.nnz, structure=structure,
                            n_touched=n_touched if compact else None,
                            gather=gmode)
                        if feedback is not None:
                            sec *= feedback.correction(**choice_labels(
                                schedule=schedule, num_chunks=nc,
                                mesh_shape=(pd, pm), compact_x=compact,
                                structure=structure, gather=gmode))
                        if thr is None:
                            per_spmv = sec / max(base_s, 1e-30)
                        else:
                            per_spmv = (measured * sec
                                        / max(algo_base_s, 1e-30))
                        cost = conv[algo] + num_spmvs * per_spmv
                        # "or best is None" keeps a valid choice even when
                        # every cost is inf (e.g. all-inf conversion
                        # priors); the strict "<" with compact=False /
                        # general / upfront scored first refuses
                        # compaction, one-triangle storage or gather
                        # hiding whenever they tie the plain candidate
                        if cost < best_cost or best is None:
                            best = DistributedChoice(algo, schedule, nc,
                                                     (pd, pm), compact,
                                                     structure, gmode)
                            best_cost = cost
    return best
