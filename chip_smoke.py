#!/usr/bin/env python3
"""Chip smoke test of the repro_torch port on one NVIDIA H100.

Builds the CUDA kernels from ``src/repro_torch/csrc``, holds every kernel
on the single-device SpMV serving path against its plain PyTorch version
on the card, drives that path end to end through the user entry point
(``repro_torch.launch.serve``) at the real size of ``hhh_like --scale 64``
(m = n = 1,048,576, 12.6 M nonzeros, k = 32 flushes), shows through the
wrappers' launch counters that the path went through the kernels, and
prints one JSON line per kernel table and a final status line:

    python3 chip_smoke.py            # full run, one card
    python3 chip_smoke.py --quick    # same phases at small scales

Phases:
  1. build the kernels (nvcc, sm_90a, one process per source);
  2. kernel vs plain version for K1 (SELL-C-σ), K2 (merge-path SpMM),
     K4 (merge-path SpMV) and the carry step on hhh_like --scale 64,
     mawi_like --scale 4 and road_like --scale 8 for k in {1, 8, 32, 33}
     (K4 is the k = 1 entry), with kernel, plain, torch.sparse CSR and
     bound times;
  3. serve path A: --algorithm sellcs (K1), one flush checked against
     the torch oracle;
  4. serve path B: --migrate force (K2, K4, carry step, one plan swap).

Bound: ``bound_ms`` is the larger of the bytes the SpMM function needs
(CSR values and columns per nonzero, one row offset per row, X read once,
Y written once; ``spmm_bytes``) over the data-sheet HBM rate and
2 * nnz * k flops over the float32 peak. The stdout ends with a ``rows``
JSON line (every kernel, matrix and k; both serve runs' headline, flush
latency, batcher phases and conversion times), the card line, the
``kernels`` JSON line and the status line.

Tolerance: a kernel agrees with its plain version when
``max|kernel - plain| <= 1e-4 * max(1, max|plain|)`` — float32 sums taken
in another order (K1 keeps the reference's order per slot but fuses the
multiply-add; K2/K4 sum each row in shares and carries). Exits non-zero on
any failure; there is no CPU fallback.
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
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.spmm import kernels as SK
    return {"K1": SK.sellcs_slots, "K2": SK._merge_spmm_partials,
            "K4": MS.merge_spmv_partials, "carry": MS.carry_out_fixup}


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
    "K4": ("merge_spmv_partials", "src/repro_torch/csrc/merge_spmm.cu",
           "src/repro/kernels/merge_spmv.py:122"),
    "carry": ("merge_carry_fixup", "src/repro_torch/csrc/merge_spmm.cu",
              "src/repro/kernels/merge_spmv.py:40"),
}


def spmm_bytes(nnz: int, m: int, n: int, k: int) -> int:
    """Bytes the SpMM function itself must move: the CSR stream (value and
    column per nonzero, one row offset per row), X read once, Y written
    once. Padding slots and the merge plan's per-item row ids are the
    port's overhead, not the function's."""
    return nnz * (4 + 4) + (m + 1) * 4 + n * k * 4 + m * k * 4


def check_kernels(name: str, scale: float, ks, reps: int, table: dict,
                  shape_rows: list, main: bool) -> None:
    """Phase 2 on one matrix: every kernel against its plain version."""
    import torch
    from repro_torch.core import coo_to_csr
    from repro_torch.data import matrices
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.spmm import kernels as SK
    from repro_torch.spmm.reference import spmm_csr
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
    del A_lib, sc, plan, csr, coo
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

    launches = {"K1": counts_a["K1"], "K2": counts_b["K2"],
                "K4": counts_b["K4"], "carry": counts_b["carry"]}
    kernels = []
    for key in ("K1", "K2", "K4", "carry"):
        nm, src, rep = KERNEL_META[key]
        row = table[key]
        kernels.append({"name": nm, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[key],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"rows": shape_rows, "serve": serve_rows}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
