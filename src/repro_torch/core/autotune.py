"""Automatic parameter tuning — the paper's §8 future work, the port of
``repro.core.autotune``.

The tuner sweeps (algorithm, block size β) and scores each candidate by
the paper's own economics: total = conversion + ``num_spmvs`` ×
per-multiply, both measured (the min-of-N protocol of
``obs.time_min_of_n``, which synchronizes CUDA). The format that wins at
``num_spmvs`` → ∞ against the zero-conversion CSR pays for its conversion
after (convert − convert_csr) / (multiply_csr − multiply) multiplies: the
paper's break-even (472 on one of its multi-CPU machines).

Where it departs from the reference, and why: the reference times
``impl="ref"``, which is XLA on its own backend. This package's oracles
are plain PyTorch that was never meant to be fast, so timing them on the
card would rank the formats by the wrong code. Each candidate is timed
through ``impl="auto"`` on the COO's device instead, the route
``SparseOperator`` serves the format with: on the card the merge-path
kernels for ``parcrs`` (K4 and the carry step at k = 1, K2 at k > 1), K1
for ``sellcs``, and the oracle for a ``BlockedSparse``, which has no
kernel. A CSR's conversion includes its merge plan there, as a
``SparseOperator`` builds it with the plan. On the CPU ``"auto"`` is the
oracle, so the port measures what the reference measures.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .convert import ALGORITHM_SPECS, block_size_for, convert
from .formats import COO, CSR
from .selector import matrix_stats
from .spmv import spmv

DEFAULT_ALGOS = ("parcrs", "csb", "csbh", "bcohc", "bcohch", "mergeb")


@dataclasses.dataclass(frozen=True)
class TuneResult:
    algorithm: str
    beta: Optional[int]
    convert_s: float
    spmv_s: float                # per multiply (one SpMM when k > 1),
                                 #   measured on ONE device
    total_s: float               # convert + num_spmvs * spmv (modelled
                                 #   distributed per-multiply when
                                 #   num_devices > 1)
    tpu_model_s: Optional[float] = None   # the reference's TPU tile-stream
                                          #   model; always None here
    k: int = 1                   # right-hand sides per multiply
    k_tile: Optional[int] = None  # roofline-chosen column block (k > 1)
    num_devices: int = 1          # mesh size the score targets
    schedule: Optional[str] = None  # "row" | "merge" (num_devices > 1)
    dist_model_s: Optional[float] = None  # modelled distributed multiply
    num_chunks: Optional[int] = None  # merge-sum pipelining depth
    mesh_shape: Optional[Tuple[int, int]] = None   # (P_data, P_model)
    compact_x: Optional[bool] = None  # compact X gather (sellcs only)
    structure: Optional[str] = None   # "symmetric" when one-triangle
                                      #   storage won (sellcs, A == A^T)
    gather: Optional[str] = None      # compact-X gather schedule
    residual: Optional[float] = None  # observed/modeled correction the
                                      #   feedback ledger applied to the
                                      #   winning distributed score


def _measure(fn: Callable, reps: int = 5, warmup: int = 2) -> float:
    """The repo's one timing protocol, ``obs.time_min_of_n`` (min of N,
    CUDA-synchronized)."""
    from repro_torch.obs.timing import time_min_of_n
    return time_min_of_n(fn, reps=reps, warmup=warmup).best_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def autotune(coo: COO, *, num_spmvs: int = 100,
             algorithms: Tuple[str, ...] = DEFAULT_ALGOS,
             betas: Optional[List[int]] = None,
             reps: int = 5, tpu_model: bool = False, k: int = 1,
             num_devices: int = 1, feedback=None, spec=None
             ) -> Tuple[TuneResult, List[TuneResult]]:
    """Return ``(best, all_results)`` over the candidate grid.

    ``k > 1`` tunes the SpMM: each measured multiply is one ``A @ X``
    with ``X: [n, k]``, ``algorithms`` may include ``"sellcs"``, and every
    result records ``choose_k_tile``'s column block. ``num_devices > 1``
    (or ``spec``, a ``PlanSpec`` whose pins restrict the grid) scales the
    one-device measurement by the distributed traffic model and picks the
    schedule, chunks, mesh shape, compact flag, structure and gather for
    it; ``feedback`` (a ``ResidualLedger``) corrects each candidate's
    modelled seconds by the measured residuals of matching labels.

    ``tpu_model=True`` priced candidates with the reference benchmark
    folder's TPU tile-stream model, which is not ported: it raises."""
    if tpu_model:
        raise NotImplementedError(
            "tpu_model=True prices candidates with benchmarks.spmv_tables."
            "tpu_model_time, which ports with the benchmark folder "
            "(ROADMAP.md, held for the first benchmark PR)")
    if spec is not None:
        spec = spec.canonical()
        num_devices = spec.num_devices
    from repro_torch.kernels.merge_spmv import cached_merge_plan
    from repro_torch.spmm import resolve_impl
    device = coo.device
    rng = np.random.default_rng(0)
    if k > 1:
        from repro_torch.spmm import spmm
        from repro_torch.spmm.kernels import choose_k_tile
        x = torch.from_numpy(rng.standard_normal(
            (coo.shape[1], k)).astype(np.float32)).to(device)
        k_tile = choose_k_tile(coo.shape, k, nnz=coo.nnz)

        def measure(mat):
            return _measure(lambda: spmm(mat, x, impl="auto"), reps)
    else:
        x = torch.from_numpy(rng.standard_normal(
            coo.shape[1]).astype(np.float32)).to(device)
        k_tile = None

        def measure(mat):
            return _measure(lambda: spmv(mat, x, impl="auto"), reps)

    def timed_convert(algo, **kw):
        _sync(device)
        t0 = time.perf_counter()
        mat = convert(coo, algo, **kw)
        if isinstance(mat, CSR) and resolve_impl("auto", device) != "ref":
            cached_merge_plan(mat)      # what the merge kernels read
        _sync(device)
        return mat, time.perf_counter() - t0

    results: List[TuneResult] = []
    for algo in algorithms:
        aspec = ALGORITHM_SPECS[algo]
        if not aspec.blocked:
            mat, conv_s = timed_convert(algo)
            spmv_s = measure(mat)
            results.append(TuneResult(algo, None, conv_s, spmv_s,
                                      conv_s + num_spmvs * spmv_s,
                                      k=k, k_tile=k_tile))
            continue
        base = block_size_for(coo.shape,
                              in_block_format=aspec.in_block_format)
        cand = betas or sorted({max(base // 4, 16), max(base // 2, 16),
                                base, min(base * 2, 1 << 16)})
        for beta in cand:
            kw = dict(beta=beta)
            if aspec.scheduling == "static_rows":
                kw["num_bands"] = 8
            mat, conv_s = timed_convert(algo, **kw)
            spmv_s = measure(mat)
            results.append(TuneResult(algo, beta, conv_s, spmv_s,
                                      conv_s + num_spmvs * spmv_s,
                                      k=k, k_tile=k_tile))
            del mat
    if num_devices > 1:
        stats = matrix_stats(coo)       # one O(nnz) pass for all results
        results = [_rescore_distributed(r, stats, k, num_devices, num_spmvs,
                                        feedback=feedback, spec=spec)
                   for r in results]
    best = min(results, key=lambda r: r.total_s)
    return best, results


def _rescore_distributed(r: TuneResult, stats, k: int, num_devices: int,
                         num_spmvs: int, feedback=None,
                         spec=None) -> TuneResult:
    """Scale a measured one-device result across the mesh with the
    traffic model and pick the best (schedule, mesh shape, chunks,
    compact_x, structure, gather) for it: "merge" sweeps the pipelining
    depths, both schedules every (P_data, P_model) factorization, and
    SELL-C-σ also the compact X gather (compact=False scored first, so a
    tie refuses compaction) and, on A == A^T, one-triangle storage.

    With ``feedback`` (a ``ResidualLedger``) each candidate's modelled
    seconds are multiplied by the ledger's geometric-mean observed/modeled
    residual for its labels before the min; the winner's factor lands in
    ``TuneResult.residual``."""
    from repro_torch.roofline.analysis import spmm_distributed_time
    from .selector import (GATHER_CANDIDATES, _matrix_bytes_est,
                           distributed_schedule_grid)
    mat_bytes = _matrix_bytes_est(r.algorithm, stats)
    base_s = spmm_distributed_time(stats.m, stats.n, k, 1, "row",
                                   matrix_bytes=mat_bytes)
    grid = distributed_schedule_grid(num_devices, spec=spec)
    compacts = (False, True) if r.algorithm == "sellcs" else (False,)
    if spec is not None and spec.compact_x is not None:
        compacts = ((spec.compact_x,) if r.algorithm == "sellcs"
                    else (False,))
    # one-triangle storage: executable on sellcs, convertible only when
    # A == A^T; "general" is scored first, so symmetry must strictly win
    structures = ("general",)
    if r.algorithm == "sellcs" and getattr(stats, "symmetric", False):
        structures = ("general", "symmetric")
    if spec is not None and spec.structure is not None:
        structures = ((spec.structure,) if r.algorithm == "sellcs"
                      else ("general",))

    def gathers_for(cf):
        # the gather schedule exists only on the compact SELL-C-σ path;
        # "upfront" first, so min()'s first-wins tie-break refuses hiding
        # that buys nothing
        if not (cf and r.algorithm == "sellcs"):
            return ("upfront",)
        if spec is not None and spec.gather is not None:
            return (spec.gather,)
        return GATHER_CANDIDATES

    def corrected(s, nc, mesh, cf, st, gm):
        model_s = spmm_distributed_time(
            stats.m, stats.n, k, mesh[0], s, matrix_bytes=mat_bytes,
            max_row_nnz=stats.max_row_nnz, num_chunks=nc,
            model_devices=mesh[1], compact_x=cf, nnz=stats.nnz,
            structure=st, gather=gm)
        corr = 1.0
        if feedback is not None:
            from repro_torch.obs import choice_labels
            corr = feedback.correction(**choice_labels(
                schedule=s, num_chunks=nc, mesh_shape=mesh, compact_x=cf,
                structure=st, gather=gm))
        return model_s * corr, corr

    ((schedule, num_chunks, mesh_shape, compact, structure, gmode),
     (model_s, corr)) = min(
        (((s, nc, mesh, cf, st, gm), corrected(s, nc, mesh, cf, st, gm))
         for s, nc, mesh in grid for cf in compacts for st in structures
         for gm in gathers_for(cf)),
        key=lambda t: t[1][0])
    per_multiply = r.spmv_s * (model_s / max(base_s, 1e-30))
    return dataclasses.replace(
        r, total_s=r.convert_s + num_spmvs * per_multiply,
        num_devices=num_devices, schedule=schedule, dist_model_s=model_s,
        num_chunks=num_chunks, mesh_shape=mesh_shape, compact_x=compact,
        structure=structure, gather=gmode if compact else None,
        residual=corr if feedback is not None and corr != 1.0 else None)


__all__ = ["DEFAULT_ALGOS", "TuneResult", "autotune"]
