#!/usr/bin/env python3
"""Chip smoke test of the repro_torch port on one NVIDIA H100.

Builds the CUDA kernels from ``src/repro_torch/csrc``, holds every kernel
of the ported paths against its plain PyTorch version on the card, drives
the single-device SpMV serving path end to end through the user entry
point (``repro_torch.launch.serve``) at the real size of ``hhh_like
--scale 64`` (m = n = 1,048,576, 12.6 M nonzeros, k = 32 flushes), drives
the transpose path (one-triangle symmetric storage, forward + adjoint
GMRES through ``repro_torch.examples.gmres``, gradient steps through the
differentiable ``sparse_matmul``) at 1,048,576 rows, drives the paper's
blocked formats through the tiled kernels (every blocked visit order at
road_like --scale 8), shows through the wrappers' launch counters that
each path went through its kernels, and prints one JSON line per kernel
table and a final status line:

    python3 chip_smoke.py            # full run, one card
    python3 chip_smoke.py --quick    # same phases at small scales

Phases:
  1. build the kernels (nvcc, sm_90a, one process per source);
  2. kernel vs plain version for K1 (SELL-C-σ), K3 (its transpose), K2
     (merge-path SpMM), K4 (merge-path SpMV) and the carry step on
     hhh_like --scale 64, mawi_like --scale 4 and road_like --scale 8 for
     k in {1, 8, 32, 33} (K4 is the k = 1 entry), with kernel, plain,
     torch.sparse CSR (of A^T for K3) and bound times, and the whole
     A^T X multiply (slot-X gather + K3) against the torch oracle;
  3. serve path A: --algorithm sellcs (K1), one flush checked against
     the torch oracle;
  4. serve path B: --migrate force (K2, K4, carry step, one plan swap);
  5. symmetric: road_like --scale 8 made symmetric (A + A^T, 1,048,576
     rows) and stored one-triangle; the K1 + K3 combine for op N and op T
     against the oracle of the full matrix, and its storage against the
     general format's;
  6. GMRES: ``repro_torch.examples.gmres`` at rmat scale 20 (1,048,576
     rows) pinned to SELL-C-σ, forward (K1) and adjoint (K3) solves to a
     relative residual < 1e-5 with no rebuild for the adjoint;
  7. autograd: 5 gradient steps of the sparse-mixer loss of
     ``examples/train_lm.py`` (hhh_like --scale 64, values 1/in-degree,
     d_feat = 32, d_out = 16) through ``sparse_matmul``, whose backward
     is K3; the first step's gradient against autograd through the torch
     oracle ``spmm_ref(coo, ·)``;
  8. the blocked formats (road_like --scale 8, 1,048,576 rows): for each
     of the eight blocked orders, conversion to the tiled format (seconds,
     tiles, fill, x/y window switches) and one multiply through
     ``core.spmv`` (K5) against K5's plain version and the triplet oracle,
     timed; on csb and bcohch, ``spmm`` (K6, ``choose_k_tile``'s column
     tile and a narrower one) and ``kernels.ops.bsr_spmm`` (K7) at
     k in {8, 32, 33}; mawi_like --scale 4 with K5 at k = 1 and K6/K7 at
     k = 32; ``serve --algorithm csb`` (a blocked plan, multiplied through
     its oracle) with every answer checked against the triplet oracle;
     ``repro_torch.examples.quickstart`` at road_like --scale 8; and
     hhh_like --scale 64, whose 12.5 M tiles the tiled conversion must
     refuse with ``MemoryError`` (its 8 GiB density rule).

Bound: ``bound_ms`` is the larger of the bytes the SpMM function needs
(CSR values and columns per nonzero, one row offset per row, X read once,
Y written once; ``spmm_bytes``) over the data-sheet HBM rate and
2 * nnz * k flops over the float32 peak. K5–K7 also get the bound of
their format's stream, ``stream_bound_ms``: the tile bytes plus 8 B per
tile, X and Y over the HBM rate, or the dense tile math (2 * 1024 * k
flops per tile) over the float32 peak. K8 (not ported yet) gets its bound
printed beside K1's: K1's bytes plus one int32 of its column map per
column of X. The stdout ends with a ``rows``
JSON line (every kernel, matrix and k; both serve runs' headline, flush
latency, batcher phases and conversion times; the symmetric, GMRES and
autograd phases), the card line, the ``kernels`` JSON line and the status
line. K3's ``launches`` there is the sum over the GMRES and autograd
phases, each counted from zero; K5's, K6's and K7's are the sums over
phase 8's multiplies through the entry points (``core.spmv``,
``spmm``, ``kernels.ops.bsr_spmm``, the quickstart), each window counted
from zero, not the launches made to compare or time them.

Tolerance: a kernel agrees with its plain version when
``max|kernel - plain| <= 1e-4 * max(1, max|plain|)`` (and phase 8's
multiplies agree with the triplet oracle computed in float64 by the same
rule: a float32 oracle sums mawi_like's 262,144-entry row with an error
of that order itself) — float32 sums taken
in another order (K1 keeps the reference's order per slot but fuses the
multiply-add; K2/K4 sum each row in shares and carries; K3, K5, K6 and
K7 add with atomics in an order that varies from run to run). Exits non-zero on any
failure; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL_REL = 1e-4
KS = (1, 8, 32, 33)
MAIN_K = 32               # the serve flush width (--max-batch 32)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` launches after one
    warm-up, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    """Least time for the work: bytes over the data-sheet HBM rate or
    flops over the float32 peak, whichever is larger."""
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS_FP32
    t_b = nbytes / HBM_BW
    t_f = flops / PEAK_FLOPS_FP32
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def tol_of(ref) -> float:
    return TOL_REL * max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)


def counters():
    from repro_torch.kernels import bsr_spmv as BS
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.spmm import kernels as SK
    return {"K1": SK.sellcs_slots, "K2": SK._merge_spmm_partials,
            "K3": SK.sellcs_slots_t, "K4": MS.merge_spmv_partials,
            "carry": MS.carry_out_fixup, "K5": BS.bsr_spmv,
            "K6": SK.tiled_spmm, "K7": BS.bsr_spmm}


def reset_counts():
    for w in counters().values():
        w.launches = 0


def read_counts():
    return {name: int(w.launches) for name, w in counters().items()}


KERNEL_META = {
    "K1": ("sellcs_slots", "src/repro_torch/csrc/sellcs_spmm.cu",
           "src/repro/spmm/kernels.py:342"),
    "K2": ("merge_spmm_partials", "src/repro_torch/csrc/merge_spmm.cu",
           "src/repro/spmm/kernels.py:196"),
    "K3": ("sellcs_slots_t", "src/repro_torch/csrc/sellcs_spmm.cu",
           "src/repro/spmm/kernels.py:456"),
    "K4": ("merge_spmv_partials", "src/repro_torch/csrc/merge_spmm.cu",
           "src/repro/kernels/merge_spmv.py:122"),
    "carry": ("merge_carry_fixup", "src/repro_torch/csrc/merge_spmm.cu",
              "src/repro/kernels/merge_spmv.py:40"),
    "K5": ("bsr_spmv", "src/repro_torch/csrc/tiled_spmm.cu",
           "src/repro/kernels/bsr_spmv.py:96"),
    "K6": ("tiled_spmm", "src/repro_torch/csrc/tiled_spmm.cu",
           "src/repro/spmm/kernels.py:147"),
    "K7": ("bsr_spmm", "src/repro_torch/csrc/tiled_spmm.cu",
           "src/repro/kernels/bsr_spmv.py:167"),
}
BLOCKED_ORDERS = ("csb", "csbh", "bcoh", "bcohc", "bcohch", "bcohchp",
                  "mergeb", "mergebh")


def spmm_bytes(nnz: int, m: int, n: int, k: int) -> int:
    """Bytes the SpMM function itself must move: the CSR stream (value and
    column per nonzero, one row offset per row), X read once, Y written
    once. Padding slots and the merge plan's per-item row ids are the
    port's overhead, not the function's."""
    return nnz * (4 + 4) + (m + 1) * 4 + n * k * 4 + m * k * 4


def stream_bound_ms(ts, k: int) -> float:
    """Least time for the tiled kernels' own stream: every tile read once
    with its two indices, X read once, Y written once — or the dense tile
    math at the float32 peak, whichever is larger."""
    m, n = ts.shape
    T = ts.num_tiles
    nbytes = T * (ts.tiles[0].numel() * ts.tiles.element_size() + 8) \
        + n * k * 4 + m * k * 4
    return bound_ms(nbytes, 2.0 * T * ts.tiles[0].numel() * k)[0]


def check_kernels(name: str, scale: float, ks, reps: int, table: dict,
                  shape_rows: list, main: bool) -> None:
    """Phase 2 on one matrix: every kernel against its plain version."""
    import torch
    from repro_torch.core import coo_to_csr
    from repro_torch.data import matrices
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.spmm import kernels as SK
    from repro_torch.spmm.reference import (sellcs_slot_x, spmm_coo_t,
                                            spmm_csr)
    from repro_torch.spmm.sellcs import coo_to_sellcs

    t0 = time.perf_counter()
    coo = matrices.as_coo(matrices.test_suite(scale)[name].make(),
                          device="cuda")
    csr = coo_to_csr(coo)
    plan = MS.cached_merge_plan(csr)
    sc = coo_to_sellcs(coo)
    m, n = coo.shape
    nnz = coo.nnz
    P, D = plan.cols.shape
    W, C, S = int(sc.data.shape[0]), sc.chunk, sc.num_slices
    crow, col, val = csr.row_ptr, csr.col_ind, csr.data
    A_lib = torch.sparse_csr_tensor(crow.long(), col.long(), val, (m, n))
    # cuSPARSE baseline of A^T X: a CSR of A^T, built once, never the path
    At_lib = torch.sparse_coo_tensor(
        torch.stack([coo.cols.long(), coo.rows.long()]), coo.data,
        (n, m)).coalesce().to_sparse_csr()
    print(f"[chip_smoke] {name} --scale {scale:g}: m={m} n={n} nnz={nnz} "
          f"P={P} D={D} W={W} C={C} fill={sc.fill_ratio:.3f} "
          f"(setup {time.perf_counter() - t0:.1f} s)", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for k in ks:
        X = torch.randn((n, k), generator=gen, device="cuda")
        lib_ms = cuda_ms(lambda: A_lib @ X, reps)
        rows = []

        # K1
        def k1():
            return SK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X,
                                   num_slices=S, chunk=C)

        def k1p():
            return SK.sellcs_slots_plain(sc.data, sc.cols, sc.slice_ptr, X,
                                         num_slices=S, chunk=C)
        yk, yp = k1(), k1p()
        torch.cuda.synchronize()
        b, by = bound_ms(spmm_bytes(nnz, m, n, k), 2.0 * nnz * k)
        rows.append(("K1", max_err(yk, yp), tol_of(yp), cuda_ms(k1, reps),
                     cuda_ms(k1p, max(reps // 2, 1)), b, by, lib_ms))

        # K3 (the transpose pass; X is [m, k], gathered into slot order
        # outside the timed kernel, as the reference gathers outside its
        # Pallas kernel)
        Xm = torch.randn((m, k), generator=gen, device="cuda")
        xs = sellcs_slot_x(sc.row_perm, Xm, m)

        def k3():
            return SK.sellcs_slots_t(sc.data, sc.cols, sc.slice_of,
                                     sc.slice_ptr, sc.row_len, xs,
                                     n_out=n, chunk=C)

        def k3p():
            return SK.sellcs_slots_t_plain(sc.data, sc.cols, sc.slice_of,
                                           sc.slice_ptr, sc.row_len, xs,
                                           n_out=n, chunk=C)
        yk, yp = k3(), k3p()
        torch.cuda.synchronize()
        b, by = bound_ms(spmm_bytes(nnz, n, m, k), 2.0 * nnz * k)
        rows.append(("K3", max_err(yk, yp), tol_of(yp), cuda_ms(k3, reps),
                     cuda_ms(k3p, max(reps // 2, 1)), b, by,
                     cuda_ms(lambda: At_lib @ Xm, reps)))
        # the whole A^T X multiply (slot-X gather + K3) against the oracle
        yt = SK.sellcs_spmm(sc, Xm, op="T")
        ref_t = spmm_coo_t(coo, Xm)
        err_t = max_err(yt, ref_t)
        if err_t > tol_of(ref_t):
            raise AssertionError(f"A^T X (gather + K3) vs oracle on {name} "
                                 f"k={k}: {err_t:.3g}")
        t_ms = cuda_ms(lambda: SK.sellcs_spmm(sc, Xm, op="T"), reps)
        print(f"[chip_smoke]   A^T X k={k:<2} (gather + K3) {t_ms:.4f} ms, "
              f"vs oracle max_abs_err={err_t:.3g}", flush=True)
        shape_rows.append({"matrix": name, "scale": scale, "k": k,
                           "multiply": "sellcs_spmm(op='T')", "ms": t_ms,
                           "max_abs_err": err_t})
        del Xm, xs, yt, ref_t

        # K2 + carry step
        def k2():
            return SK._merge_spmm_partials(plan, X, m)

        def k2p():
            return MS.merge_partials_plain(plan, X, m)
        (yk, crk, cvk), (yp, crp, cvp) = k2(), k2p()
        torch.cuda.synchronize()
        if not torch.equal(crk, crp):
            raise AssertionError(f"K2 carry rows differ on {name} k={k}")
        err2 = max(max_err(yk, yp), max_err(cvk, cvp))
        carry_bytes = 2 * P * (4 + 4 * k)
        b, by = bound_ms(spmm_bytes(nnz, m, n, k), 2.0 * nnz * k)
        rows.append(("K2", err2, tol_of(yp), cuda_ms(k2, reps),
                     cuda_ms(k2p, max(reps // 2, 1)), b, by, lib_ms))
        fk = MS.carry_out_fixup(yk.clone(), crk, cvk)
        fp = MS.carry_out_fixup_plain(yk.clone(), crk, cvk)
        torch.cuda.synchronize()
        nvalid = int((crk >= 0).sum())
        b, by = bound_ms(carry_bytes + 2 * nvalid * k * 4, nvalid * k)
        # timed in place on a scratch copy: repeated adds change its
        # values, not the work; the library call is the same scatter-add
        # as one index_add_ with the -1 entries masked out beforehand
        scratch = yk.clone()
        keep = crk >= 0
        rows_kept, vals_kept = crk[keep].long(), cvk[keep]
        rows.append(("carry", max_err(fk, fp), tol_of(fp),
                     cuda_ms(lambda: MS.carry_out_fixup(scratch, crk, cvk),
                             reps),
                     cuda_ms(lambda: MS.carry_out_fixup_plain(
                         scratch, crk, cvk), reps), b, by,
                     cuda_ms(lambda: scratch.index_add_(0, rows_kept,
                                                        vals_kept), reps)))
        # the whole merge multiply against the torch oracle
        err_ref = max_err(fk, spmm_csr(csr, X))
        if err_ref > tol_of(fk):
            raise AssertionError(f"merge K2+carry vs oracle on {name} "
                                 f"k={k}: {err_ref:.3g}")

        # K4 (the k = 1 entry)
        if k == 1:
            x1 = X[:, 0].contiguous()

            def k4():
                return MS.merge_spmv_partials(plan, x1, m)

            def k4p():
                return MS.merge_partials_plain(plan, x1[:, None], m)
            (yk, crk, cvk), (yp, crp, cvp) = k4(), k4p()
            torch.cuda.synchronize()
            if not torch.equal(crk, crp):
                raise AssertionError(f"K4 carry rows differ on {name}")
            err4 = max(max_err(yk, yp[:, 0]), max_err(cvk, cvp[:, 0]))
            b, by = bound_ms(spmm_bytes(nnz, m, n, 1), 2.0 * nnz)
            rows.append(("K4", err4, tol_of(yp), cuda_ms(k4, reps),
                         cuda_ms(k4p, max(reps // 2, 1)), b, by, lib_ms))

        for kern, err, tol, ms, pms, b, by, lms in rows:
            ok = err <= tol
            print(f"[chip_smoke]   {kern:<5} k={k:<2} max_abs_err={err:.3g} "
                  f"tol={tol:.3g} {'ok' if ok else 'FAIL'} kernel_ms={ms:.4f}"
                  f" plain_ms={pms:.4f} bound_ms={b:.4f} ({by}) library_ms="
                  f"{'null' if lms is None else f'{lms:.4f}'}", flush=True)
            if not ok:
                raise AssertionError(f"{kern} disagrees with its plain "
                                     f"version on {name} k={k}: {err:.3g} "
                                     f"> {tol:.3g}")
            shape_rows.append({"matrix": name, "scale": scale, "k": k,
                               "kernel": kern, "max_abs_err": err,
                               "tol": tol, "ms": ms, "plain_ms": pms,
                               "bound_ms": b, "library_ms": lms})
            want_k = 1 if kern == "K4" else MAIN_K
            if main and k == want_k:
                table[kern] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                               "bound_ms": b, "bound_by": by,
                               "library_ms": lms}
        if main and k == MAIN_K:
            # K8 (not ported yet) is K1 with a column map read beside the
            # stream: K1's bytes plus one int32 per column of X
            b8, by8 = bound_ms(spmm_bytes(nnz, m, n, k) + 4 * n,
                               2.0 * nnz * k)
            table["K8_bound"] = {"bound_ms": b8, "bound_by": by8,
                                 "matrix": name, "k": k}
            print(f"[chip_smoke]   K8 (col_map gather, not ported) k={k} "
                  f"bound_ms={b8:.4f} ({by8})", flush=True)
    del A_lib, At_lib, sc, plan, csr, coo
    torch.cuda.empty_cache()


def run_serve(argv, metrics_path):
    from repro_torch.launch import serve
    reset_counts()
    res = serve.main(argv + ["--metrics", metrics_path, "--device", "cuda"])
    counts = read_counts()
    with open(metrics_path) as f:
        doc = json.load(f)
    return res, counts, doc


def serve_summary(path: str, res, doc, counts) -> dict:
    """The serve run's headline, flush latency, batcher phases and
    conversion numbers (milliseconds), for the rows line."""
    hists = {h["name"]: h for h in doc["histograms"] if h["count"]}
    gauges = {g["name"]: g["value"] for g in doc["gauges"]}

    def ms(v):
        return None if v is None else v * 1e3
    flush = hists.get("serve/flush_s", {})
    return {"path": path, "batched_ms": res["t_batched"] * 1e3,
            "sequential_ms": res["t_seq"] * 1e3,
            "flush_p50_ms": ms(flush.get("p50")),
            "flush_p95_ms": ms(flush.get("p95")),
            "phases": {n: {"count": h["count"], "mean_ms": ms(h["mean"]),
                           "p95_ms": ms(h["p95"])}
                       for n, h in hists.items()
                       if n.startswith("batcher/")},
            "initial_build_ms": ms(res["build_s"]),
            "convert_ms": ms(gauges.get("serve/convert_s")),
            "breakeven_estimate": gauges.get("serve/breakeven_estimate"),
            "launches": counts}


def check_flush(res, max_batch: int) -> float:
    """One flush's columns against the torch oracle on the card."""
    import torch
    from repro_torch.spmm import spmm_ref
    op = res["op"]
    rids = res["rids"][:max_batch]
    X = torch.stack(res["xs"][:max_batch], dim=1)
    Y = torch.stack([res["answers"][r] for r in rids], dim=1)
    if Y.shape != (op.shape[0], len(rids)) or not torch.isfinite(Y).all():
        raise AssertionError(f"flush answers malformed: {tuple(Y.shape)}")
    ref = spmm_ref(op.plan.matrix, X)
    err = max_err(Y, ref)
    if err > tol_of(ref):
        raise AssertionError(f"flush disagrees with the oracle: {err:.3g}")
    return err


def check_symmetric(scale: float, k: int, reps: int) -> dict:
    """Phase 5: road_like made symmetric (A + A^T) and stored
    one-triangle; the K1 + K3 combine for both ops against the oracle of
    the full matrix; its storage against the general format's.

    The issue-level rule "one triangle stores <= 0.55 of the general
    format" holds for long rows (the CPU tests check it on a dense-ish
    matrix); a 5-point stencil keeps 3 of its 5 entries per row in the
    lower triangle (the diagonal stays), so the stream alone is 0.6 of the
    general one and the per-row arrays (row_perm, row_len, the dense diag)
    come on top. Here the check is that exactly one triangle is stored and
    that the ratio stays below 0.8."""
    import numpy as np
    import torch
    from repro_torch.core import to_coo
    from repro_torch.data import matrices
    from repro_torch.spmm import kernels as SK
    from repro_torch.spmm.reference import spmm_coo
    from repro_torch.spmm.sellcs import coo_to_sellcs

    t0 = time.perf_counter()
    r, c, v, shape = matrices.test_suite(scale)["road_like"].make()
    full = to_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                  np.concatenate([v, v]), shape, device="cuda")
    sym = coo_to_sellcs(full, structure="symmetric")
    gen = coo_to_sellcs(full)
    m = shape[0]
    fr, fc, _ = full.host_triplets()
    n_diag = int((fr == fc).sum())
    print(f"[chip_smoke] symmetric road_like --scale {scale:g}: m={m} "
          f"nnz={full.nnz} stored={sym.nnz} (setup "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    if sym.nnz != (full.nnz + n_diag) // 2:
        raise AssertionError(f"one triangle holds {(full.nnz + n_diag) // 2}"
                             f" entries, the format stored {sym.nnz}")
    ratio = sym.storage_bytes() / gen.storage_bytes()
    if ratio >= 0.8:
        raise AssertionError(f"one-triangle storage ratio {ratio:.3f}")
    X = torch.randn((m, k), generator=torch.Generator(
        device="cuda").manual_seed(99), device="cuda")
    ref = spmm_coo(full, X)
    errs = {}
    for op in ("N", "T"):
        errs[op] = max_err(SK.sellcs_spmm(sym, X, op=op), ref)
        if errs[op] > tol_of(ref):
            raise AssertionError(f"symmetric op={op} vs oracle: "
                                 f"{errs[op]:.3g}")
    sym_ms = cuda_ms(lambda: SK.sellcs_spmm(sym, X), reps)
    gen_ms = cuda_ms(lambda: SK.sellcs_spmm(gen, X), reps)
    print(f"[chip_smoke] symmetric k={k}: max_abs_err N {errs['N']:.3g} "
          f"T {errs['T']:.3g}; storage ratio {ratio:.4f}; multiply "
          f"one-triangle {sym_ms:.4f} ms, general {gen_ms:.4f} ms",
          flush=True)
    out = {"matrix": "road_like", "scale": scale, "k": k, "m": m,
           "nnz": full.nnz, "stored_nnz": sym.nnz,
           "storage_ratio": ratio, "max_abs_err": errs,
           "sym_ms": sym_ms, "general_ms": gen_ms}
    del full, sym, gen, X, ref
    torch.cuda.empty_cache()
    return out


def run_gmres(scale: int) -> dict:
    """Phase 6: forward and adjoint GMRES through one SELL-C-σ plan, with
    the launch counters reset just before and read just after."""
    from repro_torch.examples import gmres
    t0 = time.perf_counter()
    reset_counts()
    res = gmres.main(["--device", "cuda", "--scale", str(scale),
                      "--algorithm", "sellcs"])
    counts = read_counts()
    secs = time.perf_counter() - t0
    print(f"[chip_smoke] gmres scale {scale}: residual {res['residual']:.3g}"
          f" adjoint {res['residual_t']:.3g}; {res['stats']}; launches "
          f"{counts}; {secs:.1f} s", flush=True)
    if not (res["residual"] < 1e-5 and res["residual_t"] < 1e-5):
        raise AssertionError(f"gmres residuals {res['residual']:.3g} / "
                             f"{res['residual_t']:.3g}")
    for kern in ("K1", "K3"):
        if counts[kern] <= 0:
            raise AssertionError(f"gmres never launched {kern}")
    return {"scale": scale, "residual": res["residual"],
            "residual_t": res["residual_t"], "plan": res["plan"],
            "multiplies": res["stats"].multiplies,
            "sellcs_builds": res["stats"].sellcs_builds, "seconds": secs,
            "launches": counts}


def run_autograd(scale: float, steps: int) -> dict:
    """Phase 7: gradient steps of the sparse-mixer loss of
    ``examples/train_lm.py`` through ``sparse_matmul`` (forward K1,
    backward K3), the first gradient against autograd through the torch
    oracle, with the launch counters reset just before the steps."""
    import numpy as np
    import torch
    from repro_torch.core import PlanSpec, to_coo
    from repro_torch.data import matrices
    from repro_torch.spmm import SparseOperator, sparse_matmul, spmm_ref

    t0 = time.perf_counter()
    rows, cols, _, shape = matrices.test_suite(scale)["hhh_like"].make()
    n_nodes = shape[0]
    deg = np.bincount(cols, minlength=shape[1]).astype(np.float32)
    coo = to_coo(rows, cols, 1.0 / np.maximum(deg[cols], 1.0), shape,
                 device="cuda")
    A = SparseOperator.from_coo(coo, PlanSpec(num_devices=1,
                                              algorithm="sellcs"),
                                k_hint=16, num_spmvs=200)
    rng = np.random.default_rng(0)
    d_feat, d_out = 32, 16
    feats = torch.from_numpy(rng.standard_normal((n_nodes, d_feat))
                             .astype(np.float32)).cuda()
    w_true = torch.from_numpy(rng.standard_normal((d_feat, d_out))
                              .astype(np.float32)).cuda()
    with torch.no_grad():
        targets = sparse_matmul(A, feats @ w_true)
    print(f"[chip_smoke] autograd hhh_like --scale {scale:g}: m={n_nodes} "
          f"nnz={coo.nnz} plan {A.plan.label}/{A.plan.impl} (setup "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    def loss_of(w, mm):
        return torch.mean((mm(feats @ w) - targets) ** 2)

    # step size 1/L by power iteration on the quadratic's Hessian map
    # H(v) = 2/(n·d_out) · F^T A^T A F v (as the example does)
    with torch.no_grad():
        v = torch.from_numpy(rng.standard_normal((d_feat, d_out))
                             .astype(np.float32)).cuda()
        for _ in range(8):
            v = v / torch.linalg.norm(v)
            hv = feats.T @ sparse_matmul(A.T, sparse_matmul(A, feats @ v))
            v = 2.0 / (n_nodes * d_out) * hv
        lr = 1.0 / float(torch.linalg.norm(v))

    w = torch.zeros((d_feat, d_out), device="cuda")
    losses, grad0 = [], None
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    for _ in range(steps):
        wv = w.clone().requires_grad_(True)
        loss = loss_of(wv, lambda x: sparse_matmul(A, x))
        (g,) = torch.autograd.grad(loss, wv)
        grad0 = g if grad0 is None else grad0
        losses.append(float(loss.detach()))
        w = w - lr * g
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / steps
    counts = read_counts()
    w0 = torch.zeros((d_feat, d_out), device="cuda", requires_grad=True)
    (g_ref,) = torch.autograd.grad(
        loss_of(w0, lambda x: spmm_ref(coo, x)), w0)
    err = max_err(grad0, g_ref)
    # relative to the gradient's own size (no max(1, ·) floor: the
    # gradient is O(0.1) and the two paths differ only in K3's add order)
    tol = TOL_REL * float(g_ref.abs().max())
    print(f"[chip_smoke] autograd: {steps} steps, loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}, {step_ms:.2f} ms/step; first gradient vs "
          f"oracle max_abs_err={err:.3g} (max|grad| "
          f"{float(g_ref.abs().max()):.3g}); launches {counts}", flush=True)
    if err > tol:
        raise AssertionError(f"sparse_matmul gradient vs oracle: {err:.3g}"
                             f" > {tol:.3g}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mixer loss did not fall: {losses}")
    for kern in ("K1", "K3"):
        if counts[kern] <= 0:
            raise AssertionError(f"autograd never launched {kern}")
    out = {"scale": scale, "steps": steps, "losses": losses,
           "step_ms": step_ms, "grad_max_abs_err": err,
           "grad_max_abs": float(g_ref.abs().max()), "lr": lr,
           "launches": counts}
    del A, coo, feats, targets
    torch.cuda.empty_cache()
    return out


def run_counted(fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after: (result, counts)."""
    import torch
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts()


def tiled_rows(label: str, coo, ts, ks, kts, reps: int, A_lib,
               launches: dict, table: dict, main: bool) -> list:
    """K6 (per column tile in ``kts(k)``) and K7 at every k of ``ks`` on one
    tile stream: the multiplies through ``spmm`` and ``ops.bsr_spmm``
    counted, then each kernel against its plain version, timed beside
    the library's CSR multiply and both bounds."""
    import torch
    from repro_torch.kernels import bsr_spmv as BS
    from repro_torch.kernels import ops
    from repro_torch.spmm import choose_k_tile, spmm, spmm_ref
    from repro_torch.spmm import kernels as SK
    m, n = coo.shape
    out = []
    gen = torch.Generator(device="cuda").manual_seed(77)
    for k in ks:
        X = torch.randn((n, k), generator=gen, device="cuda")
        (y6, y7), counts = run_counted(
            lambda: (spmm(ts, X), ops.bsr_spmm(ts, X)))
        for kern in ("K6", "K7"):
            if counts[kern] != 1:
                raise AssertionError(f"{kern} launched {counts[kern]} times "
                                     f"for one multiply on {label} k={k}")
            launches[kern] += counts[kern]
        ref = spmm_ref(coo, X.double())
        for kern, y in (("K6", y6), ("K7", y7)):
            err = max_err(y, ref)
            if err > tol_of(ref):
                raise AssertionError(f"{kern} vs oracle on {label} k={k}: "
                                     f"{err:.3g}")
        lib_ms = cuda_ms(lambda: A_lib @ X, reps)
        b, by = bound_ms(spmm_bytes(coo.nnz, m, n, k), 2.0 * coo.nnz * k)
        sb = stream_bound_ms(ts, k)
        kt0 = choose_k_tile(ts.shape, k, nnz=ts.nnz)
        cases = [("K6", kt, (lambda kt=kt: SK.tiled_spmm(ts, X, k_tile=kt)),
                  (lambda: SK.tiled_spmm_plain(ts, X)))
                 for kt in kts(k, kt0)]
        cases.append(("K7", k, lambda: BS.bsr_spmm(ts, X),
                      lambda: BS.bsr_spmm_plain(ts, X)))
        for kern, kt, kfn, pfn in cases:
            yk, yp = kfn(), pfn()
            torch.cuda.synchronize()
            err, tol = max_err(yk, yp), tol_of(yp)
            ms = cuda_ms(kfn, reps)
            pms = cuda_ms(pfn, max(reps // 2, 1))
            ok = err <= tol
            print(f"[chip_smoke]   {label} {kern} k={k:<2} kt={kt:<2} "
                  f"max_abs_err={err:.3g} tol={tol:.3g} "
                  f"{'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} plain_ms="
                  f"{pms:.4f} bound_ms={b:.4f} ({by}) stream_bound_ms="
                  f"{sb:.4f} library_ms={lib_ms:.4f}", flush=True)
            if not ok:
                raise AssertionError(f"{kern} disagrees with its plain "
                                     f"version on {label} k={k} kt={kt}: "
                                     f"{err:.3g} > {tol:.3g}")
            row = {"matrix": label, "k": k, "kernel": kern, "k_tile": kt,
                   "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": pms,
                   "bound_ms": b, "bound_by": by, "stream_bound_ms": sb,
                   "library_ms": lib_ms}
            out.append(row)
            if main and k == MAIN_K and kern not in table:
                table[kern] = row
        del X, y6, y7, ref
    return out


def run_blocked(scale_road: float, scale_mawi: float, scale_dense: float,
                reps: int, table: dict) -> dict:
    """Phase 8: the paper's blocked formats on the card."""
    import numpy as np
    import torch
    from repro_torch.core import spmv
    from repro_torch.core.convert import ALGORITHM_SPECS
    from repro_torch.data import matrices
    from repro_torch.examples import quickstart
    from repro_torch.kernels import bsr_spmv as BS
    from repro_torch.kernels import coo_to_tiled
    from repro_torch.spmm import spmm_ref

    launches = {"K5": 0, "K6": 0, "K7": 0}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    coo = matrices.as_coo(matrices.test_suite(scale_road)["road_like"].make(),
                          device="cuda")
    m, n = coo.shape
    A_lib = torch.sparse_csr_tensor(*_csr_parts(coo), (m, n))
    print(f"[chip_smoke] blocked road_like --scale {scale_road:g}: m={m} "
          f"nnz={coo.nnz} (setup {time.perf_counter() - t0:.1f} s)",
          flush=True)
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(
        5), device="cuda")
    ref1 = spmm_ref(coo, x.double())
    lib1 = cuda_ms(lambda: A_lib @ x[:, None], reps)
    b1, by1 = bound_ms(spmm_bytes(coo.nnz, m, n, 1), 2.0 * coo.nnz)

    # every blocked visit order: conversion, window switches, one K5
    orders = []
    for algo in BLOCKED_ORDERS:
        bands = 8 if ALGORITHM_SPECS[algo].scheduling == "static_rows" else 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = coo_to_tiled(coo, algo, num_bands=bands)
        torch.cuda.synchronize()
        conv_s = time.perf_counter() - t0
        xsw, ysw = ts.window_switches()
        y, counts = run_counted(lambda: spmv(ts, x))
        if counts["K5"] != 1:
            raise AssertionError(f"spmv on the {algo} tiles launched K5 "
                                 f"{counts['K5']} times")
        launches["K5"] += 1
        err_ref = max_err(y, ref1)
        if err_ref > tol_of(ref1):
            raise AssertionError(f"K5 ({algo}) vs oracle: {err_ref:.3g}")
        yp = BS.bsr_spmv_plain(ts, x)
        err, tol = max_err(y, yp), tol_of(yp)
        if err > tol:
            raise AssertionError(f"K5 disagrees with its plain version on "
                                 f"{algo}: {err:.3g} > {tol:.3g}")
        ms = cuda_ms(lambda: BS.bsr_spmv(ts, x), reps)
        pms = cuda_ms(lambda: BS.bsr_spmv_plain(ts, x), max(reps // 2, 1))
        sb = stream_bound_ms(ts, 1)
        row = {"matrix": "road_like", "scale": scale_road, "order": algo,
               "num_bands": bands, "convert_s": conv_s,
               "tiles": ts.num_tiles, "fill": ts.fill_ratio,
               "x_switches": xsw, "y_switches": ysw, "kernel": "K5",
               "max_abs_err": err, "tol": tol, "oracle_err": err_ref,
               "ms": ms, "plain_ms": pms, "bound_ms": b1, "bound_by": by1,
               "stream_bound_ms": sb, "library_ms": lib1}
        orders.append(row)
        if "K5" not in table:
            table["K5"] = row
        print(f"[chip_smoke]   {algo:<8} convert {conv_s:.2f} s, tiles "
              f"{ts.num_tiles}, fill {ts.fill_ratio:.4f}, switches x={xsw} "
              f"y={ysw}; K5 {ms:.4f} ms (plain {pms:.4f}, bound {b1:.4f}, "
              f"stream {sb:.4f}, library {lib1:.4f}) max_abs_err {err:.3g}",
              flush=True)
        del ts, y, yp
        torch.cuda.empty_cache()

    # K6 and K7 on a row-ordered and a Hilbert-ordered stream
    spmm_rows = []
    for algo in ("csb", "bcohch"):
        bands = 8 if ALGORITHM_SPECS[algo].scheduling == "static_rows" else 0
        ts = coo_to_tiled(coo, algo, num_bands=bands)
        spmm_rows += tiled_rows(
            f"road_like/{algo}", coo, ts, (8, MAIN_K, MAIN_K + 1),
            lambda k, kt0: [kt0] + ([kt0 // 4] if kt0 >= 4 else []), reps,
            A_lib,
            launches, table, main=(algo == "csb"))
        del ts
        torch.cuda.empty_cache()
    del A_lib
    torch.cuda.empty_cache()

    # mawi_like: the dense row spread over thousands of tiles of one row
    t0 = time.perf_counter()
    mawi = matrices.as_coo(
        matrices.test_suite(scale_mawi)["mawi_like"].make(), device="cuda")
    ts = coo_to_tiled(mawi, "csb")
    mm, mn = mawi.shape
    M_lib = torch.sparse_csr_tensor(*_csr_parts(mawi), (mm, mn))
    print(f"[chip_smoke] blocked mawi_like --scale {scale_mawi:g}: m={mm} "
          f"nnz={mawi.nnz} tiles={ts.num_tiles} fill={ts.fill_ratio:.4f} "
          f"(setup {time.perf_counter() - t0:.1f} s)", flush=True)
    xm = torch.randn(mn, generator=torch.Generator(device="cuda").manual_seed(
        6), device="cuda")
    ym, counts = run_counted(lambda: spmv(ts, xm))
    if counts["K5"] != 1:
        raise AssertionError(f"spmv on mawi_like launched K5 "
                             f"{counts['K5']} times")
    launches["K5"] += 1
    refm = spmm_ref(mawi, xm.double())
    ypm = BS.bsr_spmv_plain(ts, xm)
    errm, err_refm = max_err(ym, ypm), max_err(ym, refm)
    if errm > tol_of(ypm):
        raise AssertionError(f"K5 disagrees with its plain version on "
                             f"mawi_like: {errm:.3g} > {tol_of(ypm):.3g}")
    if err_refm > tol_of(refm):
        raise AssertionError(f"K5 vs oracle on mawi_like: {err_refm:.3g} > "
                             f"{tol_of(refm):.3g}")
    bm, bym = bound_ms(spmm_bytes(mawi.nnz, mm, mn, 1), 2.0 * mawi.nnz)
    mawi_k5 = {"matrix": "mawi_like", "scale": scale_mawi, "kernel": "K5",
               "k": 1, "max_abs_err": errm, "tol": tol_of(ypm),
               "oracle_err": err_refm,
               "ms": cuda_ms(lambda: BS.bsr_spmv(ts, xm), reps),
               "plain_ms": cuda_ms(lambda: BS.bsr_spmv_plain(ts, xm), 1),
               "bound_ms": bm, "bound_by": bym,
               "stream_bound_ms": stream_bound_ms(ts, 1),
               "library_ms": cuda_ms(lambda: M_lib @ xm[:, None], reps)}
    print(f"[chip_smoke]   mawi_like K5 {mawi_k5['ms']:.4f} ms (plain "
          f"{mawi_k5['plain_ms']:.4f}, bound {bm:.4f}, stream "
          f"{mawi_k5['stream_bound_ms']:.4f}, library "
          f"{mawi_k5['library_ms']:.4f}) max_abs_err {errm:.3g}", flush=True)
    spmm_rows.append(mawi_k5)
    spmm_rows += tiled_rows("mawi_like/csb", mawi, ts, (MAIN_K,),
                            lambda k, kt0: [kt0], reps, M_lib, launches,
                            table, main=False)
    del ts, mawi, M_lib, ym, ypm, refm
    torch.cuda.empty_cache()

    # the operator path: a pinned blocked plan served through its oracle
    with tempfile.TemporaryDirectory() as tmp:
        res, _, doc = run_serve(
            ["--mode", "spmv", "--matrix", "road_like", "--scale",
             f"{scale_road:g}", "--requests", "16", "--max-batch", "8",
             "--reps", "1", "--algorithm", "csb"],
            os.path.join(tmp, "blocked.json"))
    op = res["op"]
    if op.plan.label != "csb" or op.plan.impl != "ref":
        raise AssertionError(f"serve --algorithm csb realized "
                             f"{op.plan.label}/{op.plan.impl}")
    X = torch.stack(res["xs"], dim=1)
    Y = torch.stack([res["answers"][r] for r in res["rids"]], dim=1)
    ref = spmm_ref(coo, X.double())
    if Y.shape != ref.shape or not torch.isfinite(Y).all():
        raise AssertionError(f"blocked serve answers malformed: "
                             f"{tuple(Y.shape)}")
    err_serve = max_err(Y, ref)
    if err_serve > tol_of(ref):
        raise AssertionError(f"blocked serve vs oracle: {err_serve:.3g}")
    serve_row = serve_summary("blocked", res, doc, {})
    serve_row["max_abs_err"] = err_serve
    print(f"[chip_smoke] serve --algorithm csb: {len(res['rids'])} answers "
          f"vs oracle max_abs_err {err_serve:.3g}; batched "
          f"{res['t_batched'] * 1e3:.2f} ms, sequential "
          f"{res['t_seq'] * 1e3:.2f} ms, plan build {res['build_s']:.2f} s",
          flush=True)
    del res, op, X, Y, ref, coo
    torch.cuda.empty_cache()

    # a density the tiled format refuses: the reference's rule (f32 tiles
    # over 8 GiB raise MemoryError, checked before any tile is allocated;
    # the limit scales with --quick's smaller matrix)
    t0 = time.perf_counter()
    dense = matrices.as_coo(
        matrices.test_suite(scale_dense)["hhh_like"].make(), device="cpu")
    try:
        coo_to_tiled(dense, "csb",
                     max_bytes=int(8 * 2 ** 30 * scale_dense / 64.0))
    except MemoryError as e:
        refused = str(e)
    else:
        raise AssertionError(f"coo_to_tiled accepted hhh_like --scale "
                             f"{scale_dense:g}")
    print(f"[chip_smoke] hhh_like --scale {scale_dense:g} tiled: refused "
          f"({refused}; {time.perf_counter() - t0:.1f} s)", flush=True)
    del dense

    # the slice's entry point
    t0 = time.perf_counter()
    qs, counts = run_counted(lambda: quickstart.main(
        ["--matrix", "road_like", "--scale", f"{scale_road:g}",
         "--device", "cuda"]))
    launches["K5"] += counts["K5"]
    quick_row = {"seconds": time.perf_counter() - t0, "k5_err": qs["k5_err"],
                 "tol": qs["tol"], "errors": qs["errors"],
                 "convert_s": qs["convert_s"], "tiles": qs["tiles"],
                 "launches": counts}
    print(f"[chip_smoke] quickstart road_like --scale {scale_road:g}: "
          f"launches {counts}; {quick_row['seconds']:.1f} s", flush=True)
    for kern in ("K5", "K6", "K7"):
        if launches[kern] <= 0:
            raise AssertionError(f"the blocked path never launched {kern}")
    secs = time.perf_counter() - t_phase
    print(f"[chip_smoke] blocked phase {secs:.1f} s; launches {launches}",
          flush=True)
    return {"orders": orders, "spmm": spmm_rows, "serve": serve_row,
            "quickstart": quick_row, "dense_refused": refused,
            "launches": launches, "seconds": secs}


def _csr_parts(coo):
    """(crow, col, val) of the library's CSR of ``coo`` (a baseline only)."""
    from repro_torch.core import coo_to_csr
    csr = coo_to_csr(coo)
    return csr.row_ptr.long(), csr.col_ind.long(), csr.data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="the same phases at small scales")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: this smoke test runs on the "
              "card only", file=sys.stderr)
        return 2
    from repro_torch.kernels import _lib
    from repro_torch.roofline import device_properties

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = smi_line()
    props = device_properties()
    print(f"[chip_smoke] card: {smi}; {props['sm_count']} SMs, "
          f"{props['total_memory'] / 2 ** 30:.1f} GiB, L2 "
          f"{props['l2_bytes'] / 2 ** 20:.0f} MiB; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    built = _lib.build(verbose=True)
    for name in _lib.SOURCES:
        _lib.library(name)
    print(f"[chip_smoke] build {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})",
          flush=True)

    # phase 2: kernels vs plain versions
    div = 64.0 if args.quick else 1.0
    table: dict = {}
    shape_rows: list = []
    reps = 3 if args.quick else 5
    for i, (name, scale) in enumerate((("hhh_like", 64.0),
                                       ("mawi_like", 4.0),
                                       ("road_like", 8.0))):
        check_kernels(name, scale / div, KS, reps, table, shape_rows,
                      main=(i == 0))

    # phase 3: serve path A — SELL-C-σ pinned (K1)
    serve_scale = f"{64.0 / div:g}"
    common = ["--mode", "spmv", "--matrix", "hhh_like", "--scale",
              serve_scale, "--requests", "256", "--max-batch", str(MAIN_K),
              "--reps", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        res, counts_a, doc = run_serve(
            common + ["--algorithm", "sellcs"], os.path.join(tmp, "a.json"))
        print(f"[chip_smoke] serve A (sellcs): launches {counts_a}; "
              f"batched {res['t_batched'] * 1e3:.2f} ms, sequential "
              f"{res['t_seq'] * 1e3:.2f} ms", flush=True)
        if counts_a["K1"] <= 0:
            raise AssertionError("serve A never launched K1")
        err = check_flush(res, MAIN_K)
        print(f"[chip_smoke] serve A flush vs oracle max_abs_err {err:.3g}",
              flush=True)
        serve_rows = [serve_summary("A", res, doc, counts_a)]
        del res
        torch.cuda.empty_cache()

        # phase 4: serve path B — merge-path start, forced migration
        res, counts_b, doc = run_serve(
            common + ["--migrate", "force"], os.path.join(tmp, "b.json"))
        swaps = {c["name"]: c["value"] for c in doc["counters"]}.get(
            "serve/plan_swaps", 0)
        print(f"[chip_smoke] serve B (migrate force): launches {counts_b}; "
              f"plan_swaps {swaps:g}; batched {res['t_batched'] * 1e3:.2f} ms,"
              f" sequential {res['t_seq'] * 1e3:.2f} ms", flush=True)
        for kern in ("K2", "K4", "carry"):
            if counts_b[kern] <= 0:
                raise AssertionError(f"serve B never launched {kern}")
        if swaps != 1:
            raise AssertionError(f"serve B plan_swaps {swaps} != 1")
        check_flush(res, MAIN_K)
        serve_rows.append(serve_summary("B", res, doc, counts_b))
        del res
    torch.cuda.empty_cache()

    # phases 5-7: the transpose path
    sym_row = check_symmetric(8.0 / div, MAIN_K, reps)
    gmres_row = run_gmres(14 if args.quick else 20)
    grad_row = run_autograd(64.0 / div, 5)

    # phase 8: the blocked formats
    blocked_row = run_blocked(8.0 / div, 4.0 / div, 64.0 / div, reps, table)

    launches = {"K1": counts_a["K1"], "K2": counts_b["K2"],
                "K3": gmres_row["launches"]["K3"]
                + grad_row["launches"]["K3"],
                "K4": counts_b["K4"], "carry": counts_b["carry"],
                **blocked_row["launches"]}
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "carry", "K5", "K6", "K7"):
        nm, src, rep = KERNEL_META[key]
        row = table[key]
        entry = {"name": nm, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[key],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}
        if "stream_bound_ms" in row:
            entry["stream_bound_ms"] = row["stream_bound_ms"]
        kernels.append(entry)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"rows": shape_rows, "serve": serve_rows,
                      "symmetric": sym_row, "gmres": gmres_row,
                      "autograd": grad_row, "blocked": blocked_row,
                      "k8_bound": table["K8_bound"]}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
