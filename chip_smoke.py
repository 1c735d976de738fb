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
road_like --scale 8), drives the multi-device schedules on a mesh of four
shards that all name cuda:0 (``serve --devices 4 --mesh-devices
cuda:0,cuda:0,cuda:0,cuda:0`` and ``repro_torch.spmm.distributed``),
serves granite-moe-1b-a400m at full width (``serve --mode lm``:
prefill + greedy decode with KV caches, the MoE layers through the
grouped-GEMM kernel K9), shows through the wrappers' launch counters that
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
     refuse with ``MemoryError`` (its 8 GiB density rule);
  9. the multi-device schedules, P = 4 shards on cuda:0, k = 32: phase 2's
     hhh_like --scale 64 partitioned by row bands and by merge spans
     (num_chunks = 4), with and without compact X; the row and merge
     multiplies with up-front, overlapped and fused (K8) gathers and op T
     (K3) against the float64 oracle, the gather modes bitwise equal, K8
     on every row shard against its plain version (card, plain, library
     — ``torch.sparse`` CSR of the shard's rows — and bound ms, per shard
     and summed) beside phase 2's single-device K1; road_like --scale 8
     on the row schedule with a compact fused gather and mawi_like
     --scale 4 on the merge schedule (its dense row split over shards);
     then ``serve --devices 4 --compact-x on --gather fused`` at hhh_like
     --scale 64, whose launch counts are K8's ``launches``;
 10. LM serving: K9 against its plain version at granite-moe-1b-a400m's
     serve shapes — gate/up (K = 1024, N = 512) and down (K = 512,
     N = 1024), 32 experts, top-8, over a prefill of 4,096 tokens (32,768
     rows, T_pad 36,864) and a decode step of 32 tokens (256 rows, T_pad
     4,352), skewed seeded group sizes, bf16 rows times f32 weights; a
     decode case with 20 empty groups; f32 x f32 at the reduced widths
     (64, padded to 128) — with card, plain, bound and library ms (the
     library: ``torch.bmm`` of the live tiles by their experts' weights,
     both gathered outside the timed window); then ``serve --mode lm
     --arch granite-moe-1b-a400m --batch 32 --prompt-len 128 --gen 16
     --seed 0`` (the full config, 24 layers, 1.33e9 random parameters on
     the card; 2 layers with --quick), which must launch K9 3 x layers x
     16 times and generate tokens in range; every MoE layer of its
     prefill, fed that run's own input, must give the same output through
     K9, its plain version and the per-expert route within ``1e-2 *
     max(1, max|other|)`` (the bf16 rounding of the layer output), and the
     whole model's last-token prefill logits and first greedy token on
     the three routes are reported; last, ``torch.profiler`` over one
     prefill and three decode steps (device time by kernel, K9's share,
     idle share).

Bound: ``bound_ms`` is the larger of the bytes the SpMM function needs
(CSR values and columns per nonzero, one row offset per row, X read once,
Y written once; ``spmm_bytes``) over the data-sheet HBM rate and
2 * nnz * k flops over the float32 peak. K5–K7 also get the bound of
their format's stream, ``stream_bound_ms``: the tile bytes plus 8 B per
tile, X and Y over the HBM rate, or the dense tile math (2 * 1024 * k
flops per tile) over the float32 peak. K8's bound is summed over the
shards: each shard's nonzeros (value and column), one row offset per row,
its touched X rows with their col_map entries read once, and its rows of
Y written once. K9's bound counts the real rows (T x top-k) of bf16 lhs
read once, the f32 weights of every expert that owns a row read once and
the f32 output written once, or 2 flops per multiply-add at the float32
peak (the weights are f32 and multiplied unrounded); its ``kernels``
entry is one MoE layer (gate + up + down) of the served prefill, with the
decode step's layer in ``decode_*``. The stdout ends with a ``rows``
JSON line (every kernel, matrix and k; both serve runs' headline, flush
latency, batcher phases and conversion times; the symmetric, GMRES and
autograd phases; the mesh phase; the LM phase), the card line, the
``kernels`` JSON
line and the status
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
    from repro_torch.kernels import moe_group_matmul as MG
    from repro_torch.spmm import kernels as SK
    return {"K1": SK.sellcs_slots, "K2": SK._merge_spmm_partials,
            "K3": SK.sellcs_slots_t, "K4": MS.merge_spmv_partials,
            "carry": MS.carry_out_fixup, "K5": BS.bsr_spmv,
            "K6": SK.tiled_spmm, "K7": BS.bsr_spmm,
            "K9": MG.moe_group_matmul_padded}


def reset_counts():
    from repro_torch.spmm import kernels as SK
    for w in counters().values():
        w.launches = 0
    SK.sellcs_slots.fused_launches = 0


def read_counts():
    from repro_torch.spmm import kernels as SK
    out = {name: int(w.launches) for name, w in counters().items()}
    out["K8"] = int(SK.sellcs_slots.fused_launches)
    return out


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
    "K8": ("sellcs_slots_fused", "src/repro_torch/csrc/sellcs_spmm.cu",
           "src/repro/spmm/kernels.py:260"),
    "K9": ("moe_group_matmul_padded",
           "src/repro_torch/csrc/moe_group_matmul.cu",
           "src/repro/kernels/moe_group_matmul.py:75"),
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
                  shape_rows: list, main: bool):
    """Phase 2 on one matrix: every kernel against its plain version.
    Returns the matrix and its SELL-C-σ stream for the main matrix (the
    mesh phase reuses them), else None."""
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
    del A_lib, At_lib, plan, csr
    torch.cuda.empty_cache()
    if main:
        return coo, sc
    del sc, coo
    torch.cuda.empty_cache()
    return None


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
    ref = spmm_ref(op.plan.single, X)
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


MESH_P = 4                # shards of the mesh phase, all on cuda:0


def _shard_csr(coo, sharded, p: int):
    """The library's CSR of row shard ``p``'s rows (global columns), the
    K8 row's yardstick: the rows whose slots the band owns."""
    import torch
    sh = sharded.shards[p]
    C, m = sharded.chunk, coo.shape[0]
    slots = sharded.row_perm[sh.t_first * C:
                             (sh.t_first + sh.t_ptr.shape[0] - 1) * C].long()
    rows_p = torch.sort(slots[slots < m]).values
    sel = torch.isin(coo.rows.long(), rows_p)
    local = torch.searchsorted(rows_p, coo.rows.long()[sel])
    A = torch.sparse_coo_tensor(torch.stack([local, coo.cols.long()[sel]]),
                                coo.data[sel], (int(rows_p.numel()),
                                                coo.shape[1]))
    return A.coalesce().to_sparse_csr(), int(rows_p.numel()), int(sel.sum())


def k8_rows(coo, sharded, X, reps: int) -> dict:
    """K8 on every shard of a compact row partition: kernel vs plain
    version, card, plain and library ms, and the bound of each shard's
    work (its nonzeros' values and columns, a row offset per row, the
    touched X rows and their col_map entries read once, its rows of Y
    written once), per shard and summed."""
    import torch
    from repro_torch.spmm import kernels as SK
    k = int(X.shape[1])
    out = {"shards": [], "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_bytes": 0, "flops": 0.0, "max_abs_err": 0.0}
    for p, sh in enumerate(sharded.shards):
        kw = dict(num_slices=sh.num_slices, chunk=sharded.chunk,
                  col_map=sh.col_map)

        def kern():
            return SK.sellcs_slots(sh.data, sh.cols, sh.slice_ptr, X, **kw)

        def plain():
            return SK.sellcs_slots_plain(sh.data, sh.cols, sh.slice_ptr, X,
                                         **kw)
        yk, yp = kern(), plain()
        torch.cuda.synchronize()
        err, tol = max_err(yk, yp), tol_of(yp)
        if err > tol:
            raise AssertionError(f"K8 disagrees with its plain version on "
                                 f"shard {p}: {err:.3g} > {tol:.3g}")
        A_p, rows_p, nnz_p = _shard_csr(coo, sharded, p)
        nbytes = (nnz_p * 8 + (rows_p + 1) * 4
                  + sh.n_touched * (k * 4 + 4) + rows_p * k * 4)
        b, by = bound_ms(nbytes, 2.0 * nnz_p * k)
        row = {"shard": p, "rows": rows_p, "nnz": nnz_p,
               "n_touched": sh.n_touched, "max_abs_err": err, "tol": tol,
               "ms": cuda_ms(kern, reps),
               "plain_ms": cuda_ms(plain, max(reps // 2, 1)),
               "library_ms": cuda_ms(lambda: A_p @ X, reps),
               "bound_ms": b, "bound_by": by}
        out["shards"].append(row)
        for key in ("ms", "plain_ms", "library_ms"):
            out[key] += row[key]
        out["bound_bytes"] += nbytes
        out["flops"] += 2.0 * nnz_p * k
        out["max_abs_err"] = max(out["max_abs_err"], err)
        print(f"[chip_smoke]   K8 shard {p}: rows {rows_p} nnz {nnz_p} "
              f"touched {sh.n_touched} max_abs_err={err:.3g} tol={tol:.3g} "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={b:.4f} ({by})",
              flush=True)
        del A_p, yk, yp
    out["bound_ms"], out["bound_by"] = bound_ms(out["bound_bytes"],
                                                out["flops"])
    return out


def mesh_case(label, fn, X, ref, reps, counts_need=()):
    """One multiply over the mesh: counted, checked against the float64
    oracle, timed. Returns (answer, row)."""
    import torch
    y, counts = run_counted(fn)
    if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"mesh {label}: malformed answer "
                             f"{tuple(y.shape)}")
    err, tol = max_err(y, ref), tol_of(ref)
    if err > tol:
        raise AssertionError(f"mesh {label} vs oracle: {err:.3g} > "
                             f"{tol:.3g}")
    for kern in counts_need:
        if counts[kern] <= 0:
            raise AssertionError(f"mesh {label} never launched {kern}")
    ms = cuda_ms(fn, reps)
    print(f"[chip_smoke]   mesh {label:<28} {ms:.4f} ms  max_abs_err="
          f"{err:.3g} tol={tol:.3g} launches K1 {counts['K1']} K8 "
          f"{counts['K8']} K3 {counts['K3']}", flush=True)
    return y, {"case": label, "ms": ms, "max_abs_err": err, "tol": tol,
               "launches": {k: counts[k] for k in ("K1", "K3", "K8")}}


def run_mesh(coo, sc, k1_ms: float, scale_road: float, scale_mawi: float,
             serve_scale: str, reps: int, table: dict) -> dict:
    """Phase 9: the multi-device schedules on a mesh of MESH_P shards that
    all name cuda:0."""
    import torch
    from repro_torch.data import matrices
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.spmm import distributed as TD
    from repro_torch.spmm import spmm_ref
    from repro_torch.spmm.sellcs import coo_to_sellcs

    t_phase = time.perf_counter()
    devs = ["cuda:0"] * MESH_P
    mesh = make_spmm_mesh((MESH_P, 1), devices=devs)
    m, n = coo.shape
    gen = torch.Generator(device="cuda").manual_seed(4242)
    X = torch.randn((n, MAIN_K), generator=gen, device="cuda")
    Xt = torch.randn((m, MAIN_K), generator=gen, device="cuda")
    ref = spmm_ref(coo, X.double())
    ref_t = spmm_ref(coo, Xt.double(), op="T")
    parts, part_s = {}, {}
    for label, fn, kw in (
            ("row", TD.partition_sellcs_rows, {}),
            ("row/cx", TD.partition_sellcs_rows, {"compact_x": True}),
            ("merge4", TD.partition_sellcs_nnz, {"num_chunks": 4}),
            ("merge4/cx", TD.partition_sellcs_nnz,
             {"num_chunks": 4, "compact_x": True})):
        t0 = time.perf_counter()
        parts[label] = fn(sc, MESH_P, devices=devs, **kw)
        part_s[label] = time.perf_counter() - t0
    nt = [sh.n_touched for sh in parts["row/cx"].shards]
    print(f"[chip_smoke] mesh hhh_like: P={MESH_P} on cuda:0, k={MAIN_K}; "
          f"partition s {', '.join(f'{k} {v:.2f}' for k, v in part_s.items())}"
          f"; row/cx touched {nt} of n={n}", flush=True)

    def row(label, gather=None, op="N", x=X):
        return lambda: TD.spmm_row_distributed(parts[label], x, mesh,
                                               gather=gather, op=op)

    def merge(label, gather=None, op="N", x=X):
        return lambda: TD.spmm_merge_distributed(
            parts[label], x, mesh, num_chunks=4, gather=gather, op=op)

    rows, ys = [], {}
    for label, fn, need in (
            ("row", row("row"), ("K1",)),
            ("row/cx upfront", row("row/cx", "upfront"), ("K1",)),
            ("row/cx fused", row("row/cx", "fused"), ("K8",)),
            ("merge4", merge("merge4"), ("K1",)),
            ("merge4/cx upfront", merge("merge4/cx", "upfront"), ("K1",)),
            ("merge4/cx overlap", merge("merge4/cx", "overlap"), ("K1",)),
            ("merge4/cx fused", merge("merge4/cx", "fused"), ("K8",))):
        ys[label], r = mesh_case(label, fn, X, ref, reps, need)
        rows.append(r)
    for a, b in (("row/cx upfront", "row/cx fused"),
                 ("merge4/cx upfront", "merge4/cx fused"),
                 ("merge4/cx upfront", "merge4/cx overlap")):
        if not torch.equal(ys[a], ys[b]):
            raise AssertionError(f"mesh {b} is not bitwise equal to {a}")
    del ys
    for label, fn in (("row/cx op=T", row("row/cx", op="T", x=Xt)),
                      ("merge4 op=T", merge("merge4", op="T", x=Xt))):
        _, r = mesh_case(label, fn, Xt, ref_t, reps, ("K3",))
        rows.append(r)
    print(f"[chip_smoke]   single-device K1 at k={MAIN_K}: {k1_ms:.4f} ms "
          "(phase 2)", flush=True)
    k8 = k8_rows(coo, parts["row/cx"], X, reps)
    print(f"[chip_smoke]   K8 over {MESH_P} shards: {k8['ms']:.4f} ms "
          f"(plain {k8['plain_ms']:.4f}, library {k8['library_ms']:.4f}, "
          f"bound {k8['bound_ms']:.4f} {k8['bound_by']})", flush=True)
    del parts, ref, ref_t, X, Xt
    torch.cuda.empty_cache()

    # road_like: narrow column bands, where compaction pays
    others = []
    for name, scale, part_fn, kw, gathers, need in (
            ("road_like", scale_road, TD.partition_sellcs_rows,
             {"compact_x": True}, ("upfront", "fused"), "K8"),
            ("mawi_like", scale_mawi, TD.partition_sellcs_nnz,
             {"num_chunks": 4}, (None,), "K1")):
        c2 = matrices.as_coo(matrices.test_suite(scale)[name].make(),
                             device="cuda")
        s2 = coo_to_sellcs(c2)
        part = part_fn(s2, MESH_P, devices=devs, **kw)
        x2 = torch.randn((c2.shape[1], MAIN_K), generator=gen,
                         device="cuda")
        ref2 = spmm_ref(c2, x2.double())
        fn = (TD.spmm_row_distributed if part.schedule == "row"
              else TD.spmm_merge_distributed)
        extra = {} if part.schedule == "row" else {"num_chunks": 4}
        outs = []
        for g in gathers:
            y, r = mesh_case(f"{name} {part.schedule}"
                             + (f"/cx {g}" if g else "/chunks=4"),
                             lambda g=g: fn(part, x2, mesh, gather=g,
                                            **extra), x2, ref2, reps,
                             (need,) if g in (None, "fused") else ("K1",))
            outs.append(y)
            r.update(matrix=name, scale=scale, nnz=c2.nnz)
            if part.col_map is not None:
                r["n_touched"] = [sh.n_touched for sh in part.shards]
            others.append(r)
        if len(outs) == 2 and not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"{name}: fused is not bitwise equal to "
                                 "up-front")
        del c2, s2, part, x2, ref2, outs
        torch.cuda.empty_cache()

    # the main path of this slice: serve over the mesh, through the user's
    # entry point, the counts set to 0 just before and read just after
    with tempfile.TemporaryDirectory() as tmp:
        res, counts, doc = run_serve(
            ["--mode", "spmv", "--matrix", "hhh_like", "--scale",
             serve_scale, "--requests", "128", "--max-batch", str(MAIN_K),
             "--reps", "1", "--devices", str(MESH_P), "--mesh-devices",
             ",".join(devs), "--compact-x", "on", "--gather", "fused"],
            os.path.join(tmp, "mesh.json"))
    if counts["K8"] <= 0:
        raise AssertionError(f"serve --devices never launched K8: {counts}")
    err = check_flush(res, MAIN_K)
    serve_row = serve_summary("mesh", res, doc, counts)
    serve_row.update(plan=res["op"].plan.label, max_abs_err=err,
                     phases_spmm={
                         h["name"]: {"count": h["count"],
                                     "mean_ms": h["mean"] * 1e3}
                         for h in doc["histograms"]
                         if h["count"] and h["name"].startswith("spmm/")})
    print(f"[chip_smoke] serve --devices {MESH_P} (mesh of cuda:0): plan "
          f"{res['op'].plan.label}; launches {counts}; batched "
          f"{res['t_batched'] * 1e3:.2f} ms, sequential "
          f"{res['t_seq'] * 1e3:.2f} ms; flush vs oracle max_abs_err "
          f"{err:.3g}", flush=True)
    del res
    torch.cuda.empty_cache()
    k8_table = {"max_abs_err": k8["max_abs_err"], "ms": k8["ms"],
                "plain_ms": k8["plain_ms"], "bound_ms": k8["bound_ms"],
                "bound_by": k8["bound_by"], "library_ms": k8["library_ms"],
                "per_shard_ms": [r["ms"] for r in k8["shards"]]}
    table["K8"] = k8_table
    secs = time.perf_counter() - t_phase
    print(f"[chip_smoke] mesh phase {secs:.1f} s", flush=True)
    return {"hhh": rows, "k1_single_ms": k1_ms, "partition_s": part_s,
            "k8": k8, "others": others, "serve": serve_row,
            "launches": counts, "seconds": secs}


# granite-moe-1b-a400m's MoE layer: d_model, d_ff (per expert), experts,
# top-k; the served batch (--batch 32 --prompt-len 128 --gen 16)
GRANITE = {"d": 1024, "f": 512, "E": 32, "top": 8}
LM_BATCH, LM_PROMPT, LM_GEN = 32, 128, 16
# one MoE layer's bf16 output, K9 against another route on the same input:
# float32 sums in another order can round an output to the neighbouring
# bf16 value, one step of at most 2^-7 = 0.0078 of the largest output
LAYER_TOL_REL = 1e-2
# whole-model last-token logits, reported as the share of rows within
# this of the other route (not held: routing can tip, see moe_layer_check)
LM_TOL_REL = 2e-2


def k9_gemm_work(rows: int, kin: int, nout: int, n_used: int,
                 lhs_bytes: int):
    """(bytes, flops) one grouped GEMM needs: the ``rows`` real rows of
    lhs read once, the f32 weights of the ``n_used`` experts that own rows
    read once, the f32 output written once; 2 flops per multiply-add."""
    return (rows * kin * lhs_bytes + n_used * kin * nout * 4
            + rows * nout * 4, 2.0 * rows * kin * nout)


def k9_bounds() -> list:
    """The least time of one granite MoE layer's three grouped GEMMs
    (gate, up: [T*8, 1024] x [32, 1024, 512]; down: [T*8, 512] x
    [32, 512, 1024]) with bf16 activations, f32 weights and f32 outputs,
    all 32 experts used: for a prefill of T = 4,096 tokens and a decode
    step of T = 32. The flops go at the f32 FMA peak (the weights are f32
    and are multiplied unrounded)."""
    d, f, E, top = (GRANITE[k] for k in ("d", "f", "E", "top"))
    out = []
    for tokens in (4096, 32):
        nbytes = flops = 0.0
        for kin, nout in ((d, f), (d, f), (f, d)):
            b, fl = k9_gemm_work(tokens * top, kin, nout, E, 2)
            nbytes += b
            flops += fl
        bms, by = bound_ms(nbytes, flops)
        out.append({"tokens": tokens, "bytes": nbytes, "flops": flops,
                    "bound_ms": bms, "bound_by": by})
    return out


def skewed_sizes(tokens: int, E: int, top: int, gen, empty: int = 0):
    """Group sizes of ``tokens`` tokens routed to ``top`` distinct experts
    each, drawn with probability ~ 1/rank^1.2 (a skewed router); the last
    ``empty`` experts get no token."""
    import torch
    live = E - empty
    p = 1.0 / torch.arange(1, live + 1, device="cuda",
                           dtype=torch.float32) ** 1.2
    pick = torch.multinomial(p.expand(tokens, live), top,
                             replacement=False, generator=gen)
    return torch.bincount(pick.reshape(-1), minlength=E)


def k9_case(label, tokens: int, E: int, top: int, kin: int, nout: int,
            lhs_dtype, reps: int, gen, empty: int = 0) -> dict:
    """K9 on one grouped GEMM: the group padding of ``kernels.ops`` over
    skewed group sizes, the kernel against its plain version, timed with
    its plain version, its bound and the library yardstick: ``torch.bmm``
    of the live m-tiles (f32) by their experts' weights, both gathered
    outside the timed window (no single PyTorch call takes per-tile expert
    ids)."""
    import torch
    from repro_torch.kernels import moe_group_matmul as MG
    from repro_torch.kernels import ops as KO
    sizes = skewed_sizes(tokens, E, top, gen, empty)
    rows = tokens * top
    kp = -(-kin // 128) * 128
    np_ = -(-nout // 128) * 128
    xs = torch.randn((rows, kin), generator=gen, device="cuda").to(lhs_dtype)
    w = torch.randn((E, kp, np_), generator=gen, device="cuda") * kin ** -0.5
    w[:, kin:] = 0.0
    w[:, :, nout:] = 0.0
    gp = KO.moe_group_pad(xs, sizes, E, kp)

    def kern():
        return MG.moe_group_matmul_padded(gp.lhs, w, gp.tile_expert,
                                          n_rows=gp.n_rows)

    def plain():
        return MG.moe_group_matmul_padded_plain(gp.lhs, w, gp.tile_expert,
                                                n_rows=gp.n_rows)
    yk, yp = kern(), plain()
    torch.cuda.synchronize()
    err, tol = max_err(yk, yp), tol_of(yp)
    # the whole ops-level multiply (padding, K9, unpadding) against the
    # per-token oracle on the unpadded operands
    from repro_torch.kernels.ref import moe_group_matmul_ref
    full = KO.moe_group_matmul(xs, w[:, :kin, :nout], sizes)
    n_live = int(gp.n_rows) // 128
    # (the oracle gathers a weight block per row: decode sizes only)
    err_ref = (max_err(full, moe_group_matmul_ref(xs, w[:, :kin, :nout],
                                                  sizes))
               if rows <= 512 else None)
    a_lib = gp.lhs[:n_live * 128].float().view(n_live, 128, kp)
    w_lib = w[gp.tile_expert[:n_live].long()]
    lib_ms = cuda_ms(lambda: torch.bmm(a_lib, w_lib), reps)
    n_used = int((sizes > 0).sum())
    nbytes, flops = k9_gemm_work(rows, kin, nout, n_used,
                                 xs.element_size())
    b, by = bound_ms(nbytes, flops)
    row = {"case": label, "tokens": tokens, "rows": rows, "K": kin,
           "N": nout, "experts": E, "experts_used": n_used,
           "lhs_dtype": str(lhs_dtype).replace("torch.", ""),
           "t_pad": int(gp.lhs.shape[0]), "live_tiles": n_live,
           "max_abs_err": err, "tol": tol, "oracle_err": err_ref,
           "ms": cuda_ms(kern, reps),
           "plain_ms": cuda_ms(plain, max(reps // 2, 1)),
           "bound_ms": b, "bound_by": by, "bytes": nbytes, "flops": flops,
           "library_ms": lib_ms,
           "max_group": int(sizes.max()), "empty_groups": E - n_used}
    del a_lib, w_lib, full, yk, yp, gp, w, xs
    torch.cuda.empty_cache()
    ok = err <= tol and (err_ref is None or err_ref <= tol)
    print(f"[chip_smoke]   K9 {label:<18} rows={rows} K={kin} N={nout} "
          f"used={n_used}/{E} live_tiles={n_live} max_abs_err={err:.3g} "
          f"tol={tol:.3g} oracle_err={err_ref} {'ok' if ok else 'FAIL'} "
          f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
          f"bound_ms={b:.4f} ({by}) library_ms={lib_ms:.4f}", flush=True)
    if not ok:
        raise AssertionError(f"K9 disagrees on {label}: {err:.3g} / "
                             f"{err_ref} > {tol:.3g}")
    return row


def run_lm(quick: bool, reps: int, table: dict) -> dict:
    """Phase 10: K9 against its plain version at granite's serve shapes,
    then ``serve --mode lm`` on granite-moe-1b-a400m at full width (all
    24 layers; 2 with --quick), random weights from seed 0, its launch
    counts read around the run, every MoE layer held against K9's plain
    version and the per-expert route on the run's own inputs, the whole
    model's logits on those routes reported, and a profile."""
    import dataclasses

    import torch
    from repro_torch.launch import serve
    from repro_torch.models.accounting import count_params
    from repro_torch.models.model import prefill

    t_phase = time.perf_counter()
    d, f, E, top = (GRANITE[k] for k in ("d", "f", "E", "top"))
    gen = torch.Generator(device="cuda").manual_seed(2024)
    prefill_tokens = LM_BATCH * LM_PROMPT
    cases = []
    for label, tokens in (("prefill", prefill_tokens), ("decode", LM_BATCH)):
        for name, kin, nout in (("gate_up", d, f), ("down", f, d)):
            cases.append(k9_case(f"{label}/{name}", tokens, E, top, kin,
                                 nout, torch.bfloat16, reps, gen))
    cases.append(k9_case("decode/empty_groups", LM_BATCH, E, top, d, f,
                         torch.bfloat16, reps, gen, empty=E - 12))
    cases.append(k9_case("reduced/f32", 64, 8, 4, 64, 64, torch.float32,
                         reps, gen))

    def layer(label, key):
        """One MoE layer's three launches: gate and up (one shape) and
        down, summed."""
        by = {c["case"]: c for c in cases}
        return 2 * by[f"{label}/gate_up"][key] + by[f"{label}/down"][key]

    # the kernels line's K9 entry is one MoE layer of the served prefill
    # (its bound from the summed bytes and flops), with the decode step's
    # layer beside it
    table["K9"] = {"max_abs_err": max(c["max_abs_err"] for c in cases)}
    for pre, label in (("", "prefill"), ("decode_", "decode")):
        b, by = bound_ms(layer(label, "bytes"), layer(label, "flops"))
        table["K9"].update({
            f"{pre}ms": layer(label, "ms"),
            f"{pre}plain_ms": layer(label, "plain_ms"),
            f"{pre}bound_ms": b, f"{pre}library_ms": layer(label,
                                                           "library_ms")})
        if not pre:
            table["K9"]["bound_by"] = by
    bounds = k9_bounds()

    n_layers = 2 if quick else 0
    argv = ["--mode", "lm", "--arch", "granite-moe-1b-a400m", "--batch",
            str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--seed", "0",
            "--device", "cuda"]
    # a one-layer warm-up at the same widths first, so the counted run's
    # times carry no one-time library and allocator start-up
    serve.main(argv + ["--gen", "2", "--n-layers", "1"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, counts = run_counted(lambda: serve.main(
        argv + ["--gen", str(LM_GEN), "--n-layers", str(n_layers)]))
    peak = torch.cuda.max_memory_allocated()
    cfg = res["cfg"]
    want = 3 * cfg.n_layers * LM_GEN
    if counts["K9"] != want:
        raise AssertionError(f"serve --mode lm launched K9 {counts['K9']} "
                             f"times, expected {want}")
    if res["n_params"] != count_params(cfg):
        raise AssertionError(f"{res['n_params']} parameters, accounting "
                             f"says {count_params(cfg)}")
    gen_tok = res["tokens"]
    if gen_tok.shape != (LM_BATCH, LM_GEN) or not (
            (gen_tok >= 0) & (gen_tok < cfg.vocab)).all():
        raise AssertionError(f"generated tokens malformed: "
                             f"{gen_tok.shape}")
    logits = res["prefill_logits"]
    if logits.shape != (LM_BATCH, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("prefill logits malformed")
    layers = moe_layer_check(res)
    whole = {}
    for route, over in (("plain", {"moe_plain": True}),
                        ("ref", {"moe_use_kernel": False})):
        lg, _ = prefill(res["params"], dataclasses.replace(cfg, **over),
                        res["prompts"], res["S_max"],
                        cache_dtype=torch.float32)
        tol = LM_TOL_REL * max(1.0, float(lg.abs().max()))
        row_err = (logits - lg).abs().amax(dim=-1)
        whole[route] = {
            "max_abs_err": float(row_err.max()), "tol": tol,
            "rows_within_tol": float((row_err <= tol).float().mean()),
            "first_token_agree": float((logits.argmax(-1) == lg.argmax(-1)
                                        ).float().mean())}
        del lg
    prof = profile_lm(res)
    steps = LM_GEN - 1
    lm = {"arch": cfg.name, "layers": cfg.n_layers, "batch": LM_BATCH,
          "prompt_len": LM_PROMPT, "gen": LM_GEN,
          "params": res["n_params"],
          "prefill_ms": res["t_prefill"] * 1e3,
          "decode_ms_per_step": res["t_decode"] * 1e3 / steps,
          "tok_per_s": res["tok_per_s"],
          "max_memory_allocated": peak, "launches": counts,
          "moe_layers": layers, "whole_model": whole, "profile": prof,
          "k9_cases": cases, "k9_bounds": bounds}
    print(f"[chip_smoke] serve --mode lm {cfg.name}: {cfg.n_layers} layers,"
          f" {res['n_params']} parameters; prefill {lm['prefill_ms']:.1f} ms"
          f", decode {lm['decode_ms_per_step']:.2f} ms/step "
          f"({res['tok_per_s']:.1f} tok/s); max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; K9 launches {counts['K9']}",
          flush=True)
    for route, o in whole.items():
        print(f"[chip_smoke]   whole-model prefill logits K9 vs {route}: "
              f"max_abs_err {o['max_abs_err']:.3g} (rows within "
              f"{o['tol']:.3g}: {o['rows_within_tol']:.3f}); first greedy "
              f"token agrees on {o['first_token_agree']:.3f} of the rows",
              flush=True)
    del res
    torch.cuda.empty_cache()
    lm["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] lm phase {lm['seconds']:.1f} s", flush=True)
    return lm


def moe_layer_check(res) -> dict:
    """Every MoE layer of the served prefill, fed the K9 route's own input
    at that layer, through K9, its plain version and the per-expert route.
    The router then sees one input on all three, so they route alike and
    must agree to float32 sums in another order, seen through the bf16
    rounding of the layer output: ``LAYER_TOL_REL * max(1, max|other|)``.
    (Across the whole stack the routes are compared but not held to a
    tolerance: a last-bit difference can tip a near-tied top-8 choice in a
    later layer and move that token's output by O(1).)"""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.attention import prefill_cache
    from repro_torch.models.moe import moe_apply

    params, cfg = res["params"], res["cfg"]
    mcfg = cfg.moe_config()
    routes = {"plain": mcfg._replace(plain=True),
              "ref": mcfg._replace(use_kernel=False)}
    worst = {r: {"max_abs_err": 0.0, "tol": 0.0, "layer": -1}
             for r in routes}
    with torch.no_grad():
        h = M.embed_inputs(cfg, params, res["prompts"])
        for l, lp in enumerate(params["layers"]):
            out, _ = prefill_cache(lp["mixer"], cfg.attn_config(),
                                   M._norm(cfg, lp["norm1"], h),
                                   res["S_max"], torch.float32)
            h = h + out
            hn = M._norm(cfg, lp["norm2"], h)
            yk, _ = moe_apply(lp["mlp"], mcfg, hn)
            for route, rc in routes.items():
                yo, _ = moe_apply(lp["mlp"], rc, hn)
                err = max_err(yk, yo)
                tol = LAYER_TOL_REL * max(1.0, float(yo.abs().max()))
                if err > tol:
                    raise AssertionError(f"MoE layer {l}: K9 vs {route} "
                                         f"{err:.3g} > {tol:.3g}")
                if err / tol >= worst[route]["max_abs_err"] / max(
                        worst[route]["tol"], 1e-30):
                    worst[route] = {"max_abs_err": err, "tol": tol,
                                    "layer": l}
            h = h + yk
    torch.cuda.synchronize()
    for route, w in worst.items():
        print(f"[chip_smoke]   MoE layers, K9 vs {route} on the served "
              f"prefill: worst max_abs_err {w['max_abs_err']:.3g} (layer "
              f"{w['layer']}, tol {w['tol']:.3g}) over {cfg.n_layers} "
              f"layers, ok", flush=True)
    return worst


def profile_lm(res, steps: int = 3) -> dict:
    """Device time by kernel over one prefill and ``steps`` decode steps
    of the served model (``torch.profiler``, device kernels only), K9's
    share of it, and the device's idle share of the same work timed
    without the profiler (synchronized host clock). Returns "not
    measured" entries if the profiler gives no device times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import decode_step, prefill

    params, cfg = res["params"], res["cfg"]
    B, P = res["prompts"].shape
    state = {}

    def run_prefill():
        lg, state["caches"] = prefill(params, cfg, res["prompts"],
                                      res["S_max"],
                                      cache_dtype=torch.float32)
        state["tok"] = lg.argmax(-1)[:, None].to(torch.int32)

    def run_decode():
        # the same positions each time: a rerun rewrites the same cache rows
        for i in range(steps):
            pos = torch.full((B,), P + i, dtype=torch.int32, device="cuda")
            lg, state["caches"] = decode_step(params, cfg, state["tok"],
                                              state["caches"], pos)
            state["tok"] = lg.argmax(-1)[:, None].to(torch.int32)

    def kernel_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    out = {}
    for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # device kernels only: an operator's row repeats its kernels'
            ka = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and kernel_us(e) > 0]
        except Exception as exc:   # instrumentation only: report, go on
            out[name] = {"not_measured": f"{type(exc).__name__}: {exc}"}
            continue
        busy = sum(kernel_us(e) for e in ka) / 1e3
        if busy <= 0:
            out[name] = {"not_measured": "no device times in the trace"}
            continue
        k9 = sum(kernel_us(e) for e in ka
                 if "moe_group_matmul" in e.key) / 1e3
        top = sorted(ka, key=kernel_us, reverse=True)[:8]
        o = out[name] = {
            "steps": 1 if name == "prefill" else steps, "wall_ms": wall_ms,
            "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy
                                                      / wall_ms),
            "k9_ms": k9, "k9_share_of_busy": k9 / busy,
            "kernel_launches": int(sum(e.count for e in ka)),
            "top": [{"kernel": e.key[:80], "ms": kernel_us(e) / 1e3,
                     "count": int(e.count)} for e in top]}
        print(f"[chip_smoke]   profile {name} x{o['steps']}: wall "
              f"{wall_ms:.2f} ms unprofiled, device kernels {busy:.2f} ms "
              f"(idle {o['idle_share']:.3f}), K9 {k9:.2f} ms "
              f"({o['k9_share_of_busy']:.3f} of busy), "
              f"{o['kernel_launches']} kernel launches", flush=True)
        for t in o["top"]:
            print(f"[chip_smoke]     {t['ms']:9.3f} ms x{t['count']:<5} "
                  f"{t['kernel']}", flush=True)
    return out


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
    kept = None
    for i, (name, scale) in enumerate((("hhh_like", 64.0),
                                       ("mawi_like", 4.0),
                                       ("road_like", 8.0))):
        out = check_kernels(name, scale / div, KS, reps, table, shape_rows,
                            main=(i == 0))
        kept = kept or out

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

    # phase 9: the multi-device schedules (the phase-2 hhh_like matrix)
    mesh_row = run_mesh(*kept, table["K1"]["ms"], 8.0 / div, 4.0 / div,
                        serve_scale, reps, table)
    del kept
    torch.cuda.empty_cache()

    # phase 10: LM serving (K9)
    lm_row = run_lm(args.quick, reps, table)

    launches = {"K1": counts_a["K1"], "K2": counts_b["K2"],
                "K3": gmres_row["launches"]["K3"]
                + grad_row["launches"]["K3"],
                "K4": counts_b["K4"], "carry": counts_b["carry"],
                **blocked_row["launches"],
                "K8": mesh_row["launches"]["K8"],
                "K9": lm_row["launches"]["K9"]}
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "carry", "K5", "K6", "K7", "K8",
                "K9"):
        nm, src, rep = KERNEL_META[key]
        row = table[key]
        entry = {"name": nm, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[key],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}
        for extra in ("stream_bound_ms", "per_shard_ms", "decode_ms",
                      "decode_plain_ms", "decode_bound_ms",
                      "decode_library_ms"):
            if extra in row:
                entry[extra] = row[extra]
        kernels.append(entry)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"rows": shape_rows, "serve": serve_rows,
                      "symmetric": sym_row, "gmres": gmres_row,
                      "autograd": grad_row, "blocked": blocked_row,
                      "mesh": mesh_row, "lm": lm_row}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
