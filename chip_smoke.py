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
grouped-GEMM kernel K9), serves three tenants through the fleet
(``serve --mode fleet``, one card and a mesh that loses a position),
runs the autotuner and PageRank, serves mamba2-1.3b at full width (the
Mamba-2 SSM mixer, checked against its naive recurrence) and the jamba
hybrid through K9, trains mamba2-1.3b at full width with checkpoints and
a resume, runs the ``train_lm`` example's sparse-mixer phase (K1 forward,
K3 backward), runs the LM mesh on four positions of cuda:0 (the
expert-parallel MoE dispatch through K9, ``train --mesh 2x2``), shows
through the wrappers' launch counters that
each path went through its kernels, and prints one JSON line per kernel
table and a final status line:

    python3 chip_smoke.py            # full run, one card
    python3 chip_smoke.py --quick    # same phases at small scales

Phases:
  1. build the kernels (nvcc, sm_90a, one process per source) and print
     the ``-Xptxas -v`` registers, spills and shared memory of K6/K7, K5,
     K4, K2, K3 and the three K9 kernels (and any wgmma serialization
     ptxas reports for the tensor-core one);
  2. kernel vs plain version for K1 (SELL-C-σ), K3 (its transpose), K2
     (merge-path SpMM), K4 (merge-path SpMV) and the carry step on
     hhh_like --scale 64, mawi_like --scale 4 and road_like --scale 8 for
     k in {1, 8, 32, 33} (K4 is the k = 1 entry; K2 and the carry step
     also at k = 16), with kernel, plain, torch.sparse CSR (of A^T for K3)
     and bound times, K4 also with the bound of its plan's stream and its
     time before its redesign, K2 with the bound of its X gathers if every
     one missed L2, the time of zeroing its Y alone, and two launches held
     bitwise equal, K1 as ``sellcs_spmm`` launches it (``row_len=``), two
     launches held bitwise equal, its time before its redesign, the time
     of ``sellcs_spmm``'s un-permute scatter of its slot sums
     (``unpermute_ms``), at k = 1 its ``launch_breakdown`` and, once per
     matrix, its work plan (build seconds, bytes, items, combine segments)
     and the deepest slice, and
     the whole A^T X multiply (slot-X gather + K3) against the torch
     oracle; on hhh_like at k = 32, where K3's time goes
     (``k3_breakdown``: K3 in 1, 2, 3, 4, 6 and 8 column bands, each
     held against the plain answer, the zeroing of Y, and one pass into
     a Y folded to a quarter of L2, whose adds all hit L2); the merge
     multiply as its user calls it, ``kernels.ops.merge_spmv`` at k = 1
     and ``csr_spmm`` at every k (one C entry call: the memset of Y, K4
     or K2, and the carry step launched as its programmatic dependent),
     held bitwise against the two-call path (the partials wrapper, then
     the standalone carry step), two calls bitwise equal, within the
     tolerance of the plain version, both paths timed with their
     ``launch_breakdown``; the carry step's own device time (queued
     behind a sleeping kernel) beside ``index_add_``'s;
  3. serve path A: --algorithm sellcs (K1), one flush checked against
     the torch oracle;
  4. serve path B: --migrate force (K2, K4, carry step, one plan swap;
     every K2 and K4 launch from one fused C entry call with its carry
     step);
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
     tiles, fill, x/y window switches), the build of K5's zero-free
     operand (seconds, bytes; kept on the tiles, which the following K5
     launch must reuse) and one multiply through ``core.spmv`` (K5)
     against K5's plain version and the triplet oracle, timed beside the
     operand's bound, the tile stream's and K5's time before its
     redesign; on csb and bcohch, ``spmm`` (K6 at ``choose_k_tile``'s
     column tile, timed, and at a narrower one, checked: the same launch)
     and ``kernels.ops.bsr_spmm`` (K7) at k in {8, 32, 33}, and on csb
     K6/K7 at k = 32 and K5 at k = 1 for an X with a NaN and an Inf (the
     same NaN/Inf places as the plain version, the finite outputs within
     the tolerance); where K6/K7's time goes on csb
     at k = 32 and 8 (``k67_breakdown``: K7 beside the same launch on a
     copy of the stream whose tiles are all zero, which streams the tiles
     and runs the X pre-pass but walks no X and adds nothing into Y, and
     beside the zeroing of Y); mawi_like --scale 4 with K5 at k = 1 and
     K6/K7 at k = 32; ``serve --algorithm csb`` (a blocked plan,
     multiplied through its oracle) with every answer checked against
     the triplet oracle; ``repro_torch.examples.quickstart`` at
     road_like --scale 8; and hhh_like --scale 64, whose 12.5 M tiles the
     tiled conversion must refuse with ``MemoryError`` (its 8 GiB
     density rule);
  9. the multi-device schedules, P = 4 shards on cuda:0, k = 32: phase 2's
     hhh_like --scale 64 partitioned by row bands and by merge spans
     (num_chunks = 4), with and without compact X; the row and merge
     multiplies with up-front, overlapped and fused (K8) gathers and op T
     (K3) against the float64 oracle, the gather modes bitwise equal, K8
     on every row shard (with the shard's ``row_len`` window and depth
     base, as the mesh launches it) against its plain version and bitwise
     against K1 over the up-front slab ``X[col_map]`` (card, plain,
     library — ``torch.sparse`` CSR of the shard's rows — bound ms and
     the time before its redesign, per shard and summed) beside phase
     2's single-device K1; road_like --scale 8
     on the row schedule with a compact fused gather and mawi_like
     --scale 4 on the merge schedule (its dense row split over shards);
     then ``serve --devices 4 --compact-x on --gather fused`` at hhh_like
     --scale 64, whose launch counts are K8's ``launches``;
 10. LM serving: K9 against its plain version at granite-moe-1b-a400m's
     serve shapes — gate/up (K = 1024, N = 512) and down (K = 512,
     N = 1024), 32 experts, top-8, over a prefill of 4,096 tokens (32,768
     rows, T_pad 36,864) and a decode step of 32 tokens (256 rows, T_pad
     4,352), skewed seeded group sizes, bf16 rows times f32 weights; a
     decode case with 20 empty groups, one with eight groups of exactly
     32 rows and one with f32 rows; f32 x f32 at the reduced widths
     (64, padded to 128) — each through every K9 kernel that takes it
     (the SIMT tiled kernel; the tensor-core kernel for bf16 rows; the
     decode kernel for decode sizes, which must equal the tiled kernel
     bitwise), ``route`` naming the one ``kernels.ops.moe_group_matmul``
     takes, with card, plain, both bounds and library ms (the library:
     ``torch.bmm`` of the live tiles by their experts' weights in f32 at
     the "highest" matmul precision, both gathered outside the timed
     window) and, on the prefill shapes, the tensor-core and tiled
     kernels' largest errors against the float64 product; the three
     kernels at 4–128 rows an expert (``k9_crossover``); then ``serve
     --mode lm
     --arch granite-moe-1b-a400m --batch 32 --prompt-len 128 --gen 16
     --seed 0`` (the full config, 24 layers, 1.33e9 random parameters on
     the card; 2 layers with --quick), whose MoE products must launch
     the kernel ``kernels.ops.moe_group_matmul``'s rule picks for bf16
     rows, the tensor-core kernel, 3 x layers times for the prefill and
     3 x layers x 15 for the decode steps (the SIMT kernels never), and
     generate tokens in range; the same with ``--reduced`` (2 layers, f32
     rows: the tiled kernel 3 x 2 times, the decode kernel 3 x 2 x 15);
     every MoE layer of its
     prefill, fed that run's own input, must give the same output through
     K9, its plain version and the per-expert route within ``1e-2 *
     max(1, max|other|)`` (the bf16 rounding of the layer output), and the
     whole model's last-token prefill logits and first greedy token on
     the three routes are reported; last, ``torch.profiler`` over one
     prefill and three decode steps (device time by kernel, K9's share,
     idle share);
 11. multi-tenant fleet serving: ``serve --mode fleet --matrix road_like
     --scale 8 --tenants 3 --max-batch 32 --requests 192`` (t0 and t2
     serve road_like, 1,048,576 rows, t2 a plan-cache hit on t0's
     matrix; t1 hhh_like at the same scale, 131,072 rows), (a) on one
     card (K1) and (b) over four positions of cuda:0 with ``--compact-x
     on --gather fused --fail-device auto`` (K8; the last position is
     lost halfway and every tenant re-dealt over three): per tenant its
     flush p50/p95/p99 (pre- and post-loss in b), re-deal ms and K1/K8
     launches, the plan cache's hits and misses (1 and 2) and the run's
     seconds; the serve run holds every answer against its tenant's
     oracle itself, and b must launch K8 before and after the loss;
 12. the autotuner: ``core.autotune`` at road_like --scale 8, k = 1 and
     k = 32, over the reference's ``DEFAULT_ALGOS`` and ``sellcs`` at one
     β (``block_size_for`` of the packed-COO in-block format),
     ``num_spmvs = 1000``, one candidate per call so that the counters
     name the kernel each launched (K4 and the carry step, or K2 and the
     carry step, for parcrs; K1 for sellcs; none for a blocked format,
     which multiplies through its oracle): convert, multiply and total
     seconds per candidate, and the break-even of the fastest multiply
     against parcrs, (convert - convert_parcrs) / (multiply_parcrs -
     multiply), the paper's "472 multiplies" (0 when that format also
     converts faster; none when parcrs multiplies fastest); the same for
     parcrs and sellcs at hhh_like --scale 8; one
     ``autotune(num_devices=4, k=32)`` call over parcrs and sellcs (a
     mesh plan runs only SELL-C-σ) and the schedule it picks; then
     ``repro_torch.examples.pagerank`` at rmat scale 20 (K2 and the carry
     step before its swap to SELL-C-σ, K1 after: the operator multiplies
     a vector as a one-column SpMM, as the reference's does; both rank
     vectors within 1e-5);
 13. the SSM mixer and training, with the float32 matmul precision they
     ran at printed first: ``serve --mode lm --arch mamba2-1.3b --batch 8
     --prompt-len 512 --gen 16 --seed 0`` (48 layers, d_model 2048, 1.34e9
     random parameters; 4 layers and a 64-token prompt with --quick):
     prefill ms, decode ms a step, tok/s, peak memory; layer 0's chunked
     ``ssm_forward`` against ``ssm_forward_naive`` in float32 (``1e-4 *
     max(1, max|naive|)``); for rows 0-1 the serving path (``prefill`` +
     3 greedy ``decode_step``s) in float32 compute against the naive
     recurrence through all 48 layers, teacher-forced (``1e-4 * max(1,
     max|naive|)`` on the logits, tokens equal unless the naive top two
     are within that; the same decode from caches whose conv state was
     rounded to bf16 reported beside it), and the served run itself
     (bf16 compute, its prefill and decode logits) against the naive
     recurrence in bf16 (``1e-1 * max(1, max|naive|)``: bf16 paths drift
     apart with depth) — the whole-stack naive recurrence is
     ``scan_recurrence``: ``ssm_decode``'s state update one token at a
     time, its position-wise parts computed for all tokens at once; ``torch.profiler`` over one prefill and one
     decode step; ``serve --mode lm --arch jamba-1.5-large-398b
     --reduced`` with ``--impl kernel`` against ``--impl plain`` (the
     prefill's and each decode step's logits within ``1e-2 * max(1,
     max|plain|)`` while the tokens fed agree, K9's tiled and decode
     kernels launched, none by the plain run); ``launch.train`` on
     mamba2-1.3b at full width, 3 AdamW steps at batch 4, seq 512 with
     ``--save-every 2`` (losses, ms a step, tokens/s, peak memory), then
     step 3's commit is taken back, a fresh ``Supervisor`` restores step
     2 into newly drawn parameters and step 2 runs again (profiled): its
     loss within 1e-3 relative of the first run's;
     the ``train_lm`` example's sparse-mixer phase on the card
     (``sparse_matmul`` through the operator's installed plan: the launch
     counters that moved), its plan's forward and transpose multiply
     against their plain versions at its width (k = 16), and each of its
     60 losses against the same phase through the plain versions
     (``1e-4 * max(1, loss0)``);
 14. the LM mesh on four positions of cuda:0: (a) one granite-moe-1b-
     a400m MoE layer at the served prefill shapes (32 x 128 bf16 tokens,
     random weights from seed 0) through ``moe_apply_ep`` on a (1, 4)
     mesh, the experts split four ways, local products through K9's
     tensor-core kernel: without drops (capacity factor 4) against the
     baseline ``moe_apply``, at the default 1.3 against the same dispatch
     through K9's plain version (its dropped slots printed), and
     ``moe_apply_ep_tp`` (d_ff 512 -> 128 a position) against the
     baseline, each within ``1e-2 * max(1, max|other|)``, their 36 K9
     launches counted around the three dispatches, each timed beside the
     baseline; (b) ``launch.train --arch granite-moe-1b-a400m --mesh 2x2
     --mesh-devices cuda:0,cuda:0,cuda:0,cuda:0`` against ``--mesh
     1x1``: 3 AdamW steps at full width and depth, batch 4 x seq 512
     (cut from train_4k's 256 x 4,096), no checkpoint, losses within
     1e-3 relative (bf16 compute); ms a step, tokens/s, the peak memory
     beside its reckoning (f32 parameters placed once, AdamW's moments,
     a gathered copy and its gradients per data block) and one more
     step's device events (``torch.profiler``) for both, at ``--lr
     1e-4`` (``MESH_TRAIN_LR``); the phase's seconds. A mesh of
     positions of one card measures dispatch and memory, not links.

Bound: ``bound_ms`` is the larger of the bytes the SpMM function needs
(CSR values and columns per nonzero, one row offset per row, X read once,
Y written once; ``spmm_bytes``) over the data-sheet HBM rate and
2 * nnz * k flops over the float32 peak. K5–K7 also get the bound of
their format's stream, ``stream_bound_ms``: the tile bytes plus 8 B per
tile, X and Y over the HBM rate, or the same 2 * nnz * k flops over the
float32 peak (all that a kernel on this format must compute; K6 and K7
skip the stored zeros). K5 reads the zero-free operand instead, so it
also gets ``compact_bound_ms``: the operand's bytes (4 B per tile of
offsets, a 2 B position and the value per stored nonzero) plus 8 B per
tile of indices, X and Y. K4 gets ``plan_bound_ms``: 12 B per plan item
(column, value, row id), X and Y. These stream bounds and ``prev_ms``
(the card ms before the kernel's redesign, where PERF.md has it) stay in
the phase rows and the ``rows`` line, not in the ``kernels`` line, which
holds only ``bound_ms`` and this run's measurements; the K6/K7 rows also
carry the tile stream's achieved GB/s and the nonzeros per tile. Every
kernel and library time is the mean of one window of launches after a
warm-up, by CUDA events: 5 launches, or 250 for K4, K5 and their library
calls (tens of microseconds each); ``launch_breakdown`` splits one call of each into the host's
time to issue it, its events time and the device time of each kernel it
launches (``torch.profiler``). K8's bound is summed over the shards:
each shard's nonzeros (value and column), one row offset per row, its
touched X rows with their col_map entries read once, and its rows of Y
written once. K9's bound counts the real rows (T x top-k) of bf16 lhs
read once, the f32 weights of every expert that owns a row read once and
the f32 output written once, against 2 flops per multiply-add: at the
float32 peak for the SIMT kernels (the weights are f32 and multiplied
unrounded), and three times over at the bf16 tensor-core peak (989
TFLOP/s) for the tensor-core kernel, which multiplies the rows by the
three exact bf16 terms of each weight. The ``kernels`` line's K9 entry
is the SIMT kernels: the tiled kernel on one MoE layer (gate + up +
down) of the served prefill, the decode step's layer in ``decode_*``
(the decode kernel; the tiled kernel on the same operands in
``decode_tiled_ms``), ``launches`` both kernels' in the ``--reduced``
served run (the
decode kernel's in ``decode_launches``); K9w is the tensor-core kernel
on the same prefill layer, with the float32 FMA bound in
``f32_fma_bound_ms`` and its and the tiled kernel's largest error
against the float64 product in ``f64_err`` and ``tiled_f64_err``. The
stdout
ends with a ``rows``
JSON line (every kernel, matrix and k; both serve runs' headline, flush
latency, batcher phases and conversion times; the symmetric, GMRES and
autograd phases; the mesh phase; the LM phase; the fleet and autotune
phases; the SSM and training phase; the LM mesh phase), the card line, the
``kernels`` JSON
line and the status
line. K9w's ``launches`` there is the sum of phase 10's served run and
phase 14's three EP dispatches, each counted from zero. K3's
``launches`` there is the sum over the GMRES and autograd
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
multiply-add, and adds a row cut into pieces piece by piece; K2/K4 sum
each row in shares and carries; K3, K5, K6 and
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
K2_ONLY_KS = (16,)        # phase 2 also times K2 (and the carry) here
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
    """Mean milliseconds of ``fn()`` over ``reps`` launches in one window
    after one warm-up, by CUDA events."""
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


def device_ms(fn) -> float:
    """One call's device time: calls queued behind a sleeping kernel run
    back to back however slowly the host issues them, timed by CUDA
    events (``examples/kernel_profile.py``'s measure)."""
    from repro_torch.examples.kernel_profile import device_ms as measure
    return measure(fn)


# the H100 SXM's dense bf16 tensor-core rate (NVIDIA's data sheet)
PEAK_FLOPS_BF16 = 989e12


def bound_ms(nbytes: float, flops: float, peak: float = None):
    """Least time for the work: bytes over the data-sheet HBM rate or
    flops over ``peak`` (default the float32 peak), whichever is
    larger."""
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS_FP32
    t_b = nbytes / HBM_BW
    t_f = flops / (peak or PEAK_FLOPS_FP32)
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
            "K9": MG.moe_group_matmul_padded,
            "K9d": MG.moe_group_matmul_decode,
            "K9w": MG.moe_group_matmul_wgmma}


def fused_entries():
    """The merge multiplies' one-call wrappers, whose ``.calls`` count
    their C entry calls (each launches K4 or K2 and the carry step)."""
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.spmm import kernels as SK
    return {"merge_spmv_calls": MS.merge_spmv_fused,
            "merge_spmm_calls": SK.merge_spmm_fused}


def reset_counts():
    from repro_torch.spmm import kernels as SK
    for w in counters().values():
        w.launches = 0
    for w in fused_entries().values():
        w.calls = 0
    SK.sellcs_slots.fused_launches = 0


def read_counts():
    from repro_torch.spmm import kernels as SK
    out = {name: int(w.launches) for name, w in counters().items()}
    out["K8"] = int(SK.sellcs_slots.fused_launches)
    out.update({name: int(w.calls) for name, w in fused_entries().items()})
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
    "K9w": ("moe_group_matmul_wgmma",
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


def tile_stream_bytes(ts) -> int:
    """Bytes of the tile stream: every tile with its two indices."""
    return ts.num_tiles * (ts.tiles[0].numel() * ts.tiles.element_size()
                           + 8)


def stream_bound_ms(ts, k: int) -> float:
    """Least time for the tiled kernels' own stream: every tile read once
    with its two indices, X read once, Y written once — or the 2 * nnz * k
    flops of the function at the float32 peak (all that a kernel on this
    format must compute), whichever is larger."""
    m, n = ts.shape
    nbytes = tile_stream_bytes(ts) + n * k * 4 + m * k * 4
    return bound_ms(nbytes, 2.0 * ts.nnz * k)[0]


# card ms before each kernel's redesign, as PERF.md records them: K6 and
# K7 at road_like --scale 8, csb, k = 32 (choose_k_tile's column tile);
# K5 on every blocked order of road_like --scale 8 and on mawi_like
# --scale 4; K4 on phase 2's matrices
PREV_MS = {("road_like/csb", MAIN_K, "K6"): 4.955,
           ("road_like/csb", MAIN_K, "K7"): 4.900,
           ("road_like/csb", 1, "K5"): 0.5898,
           ("road_like/csbh", 1, "K5"): 0.5879,
           ("road_like/bcoh", 1, "K5"): 0.5942,
           ("road_like/bcohc", 1, "K5"): 0.5875,
           ("road_like/bcohch", 1, "K5"): 0.5864,
           ("road_like/bcohchp", 1, "K5"): 0.5869,
           ("road_like/mergeb", 1, "K5"): 0.5921,
           ("road_like/mergebh", 1, "K5"): 0.5855,
           ("mawi_like/csb", 1, "K5"): 1.0786,
           ("hhh_like", 1, "K4"): 1.0756,
           ("mawi_like", 1, "K4"): 0.0650,
           ("road_like", 1, "K4"): 0.1910,
           ("hhh_like", MAIN_K, "K3"): 1.804,
           ("hhh_like", MAIN_K, "K2"): 1.658,
           # K1 before its redesign (the parent design's chip_smoke.py run)
           ("hhh_like", 1, "K1"): 0.1197, ("hhh_like", 8, "K1"): 0.2330,
           ("hhh_like", 32, "K1"): 0.8282, ("hhh_like", 33, "K1"): 1.0808,
           ("mawi_like", 1, "K1"): 54.51, ("mawi_like", 8, "K1"): 54.00,
           ("mawi_like", 32, "K1"): 54.82, ("mawi_like", 33, "K1"): 52.28,
           ("road_like", 1, "K1"): 0.0415, ("road_like", 8, "K1"): 0.1000,
           ("road_like", 32, "K1"): 0.3310,
           ("road_like", 33, "K1"): 0.3557,
           # the carry step before its redesign (its own wrapper, 5 calls
           # host-paced; the parent design's final chip_smoke.py run)
           ("hhh_like", 1, "carry"): 0.0145, ("hhh_like", 8, "carry"): 0.0220,
           ("hhh_like", 16, "carry"): 0.0226,
           ("hhh_like", 32, "carry"): 0.0201,
           ("hhh_like", 33, "carry"): 0.0259,
           ("mawi_like", 1, "carry"): 0.0195,
           ("mawi_like", 8, "carry"): 0.0269,
           ("mawi_like", 16, "carry"): 0.0278,
           ("mawi_like", 32, "carry"): 0.0275,
           ("mawi_like", 33, "carry"): 0.0259,
           ("road_like", 1, "carry"): 0.0165,
           ("road_like", 8, "carry"): 0.0133,
           ("road_like", 16, "carry"): 0.0203,
           ("road_like", 32, "carry"): 0.0162,
           ("road_like", 33, "carry"): 0.0143,
           # the merge multiply through its entry points before the carry
           # step's redesign (two host calls: the partials wrapper, then
           # the carry step), events ms at the host's pace, the mean of
           # two runs of kernel_profile.py --only merge on the parent tree
           ("hhh_like", 1, "merge_spmv"): 0.1331,
           ("hhh_like", 1, "csr_spmm"): 0.1953,
           ("hhh_like", 8, "csr_spmm"): 0.4225,
           ("hhh_like", 32, "csr_spmm"): 0.6654,
           ("hhh_like", 33, "csr_spmm"): 1.0596,
           ("mawi_like", 1, "merge_spmv"): 0.0465,
           ("mawi_like", 1, "csr_spmm"): 0.0508,
           ("mawi_like", 8, "csr_spmm"): 0.0633,
           ("mawi_like", 32, "csr_spmm"): 0.1012,
           ("mawi_like", 33, "csr_spmm"): 0.1406,
           ("road_like", 1, "merge_spmv"): 0.0597,
           ("road_like", 1, "csr_spmm"): 0.0691,
           ("road_like", 8, "csr_spmm"): 0.1410,
           ("road_like", 32, "csr_spmm"): 0.2332,
           ("road_like", 33, "csr_spmm"): 0.3757}
# K8 per hhh_like row shard before its redesign (the same run)
PREV_K8_MS = (0.2301, 0.2249, 0.2255, 0.2250)
# K4 and K5 take tens of microseconds: they and their library calls are
# timed as the mean of one longer window
SHORT_REPS = 250


def compact_bound_ms(ts, c) -> float:
    """Least time for K5's own stream, the zero-free operand ``c``
    (offsets, packed positions and values) with the tile indices, X read
    once and Y written once — or 2 * nnz flops at the float32 peak."""
    m, n = ts.shape
    nbytes = c.nbytes() + 8 * ts.num_tiles + 4 * n + 4 * m
    return bound_ms(nbytes, 2.0 * ts.nnz)[0]


def launch_breakdown(fn, reps: int = SHORT_REPS) -> dict:
    """Where one call of a kernel wrapper goes: the host's time to issue
    it (``reps`` calls with no synchronize in the window, per call), the
    same calls timed by CUDA events right after, and the device time of
    each kernel it launches (``torch.profiler``, per call, by kernel
    name). A wrapper whose events time is near ``host_us`` is bound by
    the host, one near ``device_us`` by the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_us = (time.perf_counter() - t0) / reps * 1e6
    events_us = cuda_ms(fn, reps) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            name = next((k for k in ("tiled_spmv_kernel", "spmv_prepass",
                                     "merge_spmv_kernel", "merge_partials",
                                     "merge_carry_fixup", "sellcs_items",
                                     "sellcs_combine", "csrmv", "spmv",
                                     "Fill", "fill")
                         if k in e.key), e.key[:48])
            device[name] = device.get(name, 0.0) + us / reps
    if not device:
        raise AssertionError("the profiler recorded no device time")
    return {"host_us": host_us, "events_us": events_us,
            "device_us": sum(device.values()), "kernels_us": device}


def breakdown_text(bd: dict) -> str:
    return (f"host {bd['host_us']:.1f} us/call, events "
            f"{bd['events_us']:.1f}, device "
            f"{bd['device_us']:.1f} us/call (" + ", ".join(
                f"{k} {v:.1f}" for k, v in bd["kernels_us"].items()) + ")")


def merge_multiply_row(name: str, k: int, label: str, fused, two_call,
                       want, reps: int) -> dict:
    """The merge multiply as its user calls it (``fused``: one C entry
    call issues the memset of Y, the partials kernel and the carry step
    launched as its programmatic dependent) against ``two_call`` (the
    partials wrapper, then the standalone carry step): bitwise equal, two
    fused calls bitwise equal, within the tolerance of the plain answer
    ``want``; both timed over ``reps`` calls, with their
    ``launch_breakdown``. Raises on any miss."""
    import torch
    yf, again, y2 = fused(), fused(), two_call()
    torch.cuda.synchronize()
    if not torch.equal(yf, y2):
        raise AssertionError(f"fused {label} differs from the two-call path"
                             f" on {name} k={k}")
    if not torch.equal(yf, again):
        raise AssertionError(f"fused {label} is not deterministic on {name}"
                             f" k={k}")
    err, tol = max_err(yf, want), tol_of(want)
    if err > tol:
        raise AssertionError(f"fused {label} disagrees with the plain "
                             f"version on {name} k={k}: {err:.3g} > "
                             f"{tol:.3g}")
    del yf, again, y2
    row = {"matrix": name, "k": k, "multiply": f"{label} (fused)",
           "max_abs_err": err, "tol": tol, "ms": cuda_ms(fused, reps),
           "two_call_ms": cuda_ms(two_call, reps),
           "prev_ms": PREV_MS.get((name, k, label))}
    row["breakdown"] = launch_breakdown(fused, reps)
    row["two_call_breakdown"] = launch_breakdown(two_call, reps)
    prev = row["prev_ms"]
    print(f"[chip_smoke]   {label} k={k:<2} fused == two-call bitwise, "
          f"max_abs_err={err:.3g} tol={tol:.3g} ok; fused {row['ms']:.4f} "
          f"ms, two-call {row['two_call_ms']:.4f} ms, prev_ms="
          f"{'None' if prev is None else f'{prev:.4f}'}; fused "
          f"{breakdown_text(row['breakdown'])}; two-call "
          f"{breakdown_text(row['two_call_breakdown'])}", flush=True)
    return row


def gather_bound_ms(nnz: int, m: int, n: int, k: int) -> float:
    """Least time for K2's X gathers if every one misses L2: each nonzero
    reads its X row (k f32, rounded up to 32-byte sectors) from HBM, plus
    the CSR stream and Y once."""
    row = -(-4 * k // 32) * 32
    return bound_ms(nnz * row + spmm_bytes(nnz, m, n, 0) + 4 * m * k,
                    2.0 * nnz * k)[0]


def plan_bound_ms(plan, m: int, n: int) -> float:
    """Least time for K4's own stream: 12 B per plan item (column, value,
    row id) of every span, X read once and Y written once."""
    items = int(plan.span_len.sum())
    return bound_ms(12 * items + 4 * n + 4 * m, 2.0 * items)[0]


def ptxas_lines(log: str, name: str) -> list:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of
    every kernel whose mangled name holds ``name``, from an nvcc log."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and name in fn and ("Used" in line or "spill" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
        elif "wgmma" in line and name in line:      # serialized wgmma
            out.append(line.strip())
    return out


def props_l2() -> int:
    """The card's L2 size in bytes (what K3's column bands are cut by)."""
    import torch
    from repro_torch.kernels import _lib
    return _lib.l2_bytes(torch.device("cuda"))


K3_BANDS = (1, 2, 3, 4, 6, 8)


def k3_breakdown(name: str, sc, xs, n: int, k: int, reps: int, yp) -> dict:
    """Where K3's time goes at one (matrix, k): the kernel in 1, 2, 3, 4,
    6 and 8 column passes (each held against the plain answer ``yp``),
    the zeroing of Y alone, and one pass on a copy of the stream whose
    columns are folded into a Y row range of a quarter of L2 (the same
    stream and adds, every add an L2 hit): the gap between that and the
    one-pass time is what Y's read-modify-write through HBM costs."""
    import torch
    from repro_torch.spmm import kernels as SK

    def run(cols, bands, n_out):
        y = torch.zeros((n_out, k), dtype=torch.float32, device="cuda")
        SK._sellcs_t_launch(sc.data, cols, sc.slice_of, sc.slice_ptr,
                            sc.row_len, xs, y, sc.chunk, bands)
        return y

    out = {"matrix": name, "k": k, "kernel": "K3 breakdown",
           "auto_bands": SK.column_bands(n, k, props_l2()),
           "y_bytes": 4 * n * k, "l2_bytes": props_l2(), "bands_ms": {}}
    for bands in K3_BANDS:
        y = run(sc.cols, bands, n)
        torch.cuda.synchronize()
        err, tol = max_err(y, yp), tol_of(yp)
        if err > tol:
            raise AssertionError(f"K3 in {bands} bands disagrees on {name}"
                                 f" k={k}: {err:.3g} > {tol:.3g}")
        out["bands_ms"][bands] = cuda_ms(lambda: run(sc.cols, bands, n),
                                         reps)
        del y
    out["zero_y_ms"] = cuda_ms(lambda: torch.zeros(
        (n, k), dtype=torch.float32, device="cuda"), reps)
    n_fit = max(props_l2() // 4 // (4 * k), 1)
    folded = torch.remainder(sc.cols, n_fit).to(torch.int32)
    out["l2_fit_rows"] = n_fit
    out["l2_fit_ms"] = cuda_ms(lambda: run(folded, 1, n_fit), reps)
    del folded
    torch.cuda.empty_cache()
    print(f"[chip_smoke]   K3 breakdown {name} k={k}: Y "
          f"{out['y_bytes'] / 2 ** 20:.0f} MiB"
          f" (L2 {out['l2_bytes'] / 2 ** 20:.0f} MiB, auto bands "
          f"{out['auto_bands']}); " + ", ".join(
              f"{b} band(s) {t:.4f} ms" for b, t in out["bands_ms"].items())
          + f"; zeroing Y {out['zero_y_ms']:.4f} ms; one pass into "
          f"{n_fit} rows (L2-resident Y) {out['l2_fit_ms']:.4f} ms",
          flush=True)
    return out


def k3_shard_rows(sharded, Xt, label: str) -> dict:
    """K3 on every shard of a partition (the arrays the mesh transpose
    hands it: a merge span may start and end mid-slice) against its plain
    version."""
    from repro_torch.spmm import kernels as SK
    from repro_torch.spmm.reference import sellcs_slot_x
    C = sharded.chunk
    xs = sellcs_slot_x(sharded.row_perm, Xt, sharded.shape[0])
    worst = {"case": f"K3 shards {label}", "max_abs_err": 0.0, "tol": 0.0}
    for sh in sharded.shards:
        if sh.data.shape[0] == 0:
            continue
        win = xs[sh.t_first * C:(sh.t_first + sh.t_ptr.shape[0] - 1) * C]
        n_out = (int(sh.col_map.shape[0]) if sh.col_map is not None
                 else sharded.shape[1])
        args = (sh.data, sh.cols, sh.t_ids, sh.t_ptr, sh.t_row_len, win)
        yk = SK.sellcs_slots_t(*args, n_out=n_out, chunk=C)
        yp = SK.sellcs_slots_t_plain(*args, n_out=n_out, chunk=C)
        err, tol = max_err(yk, yp), tol_of(yp)
        if err > tol:
            raise AssertionError(f"K3 on a shard of {label} disagrees with "
                                 f"its plain version: {err:.3g} > {tol:.3g}")
        if err / tol >= worst["max_abs_err"] / max(worst["tol"], 1e-30):
            worst.update(max_abs_err=err, tol=tol)
    print(f"[chip_smoke]   K3 vs plain on the shards of {label}: worst "
          f"max_abs_err {worst['max_abs_err']:.3g} (tol {worst['tol']:.3g})"
          ", ok", flush=True)
    return worst


def unpermute(sc, y_slots, m: int):
    """``sellcs_spmm``'s scatter of K1's slot sums back to natural row
    order (padding slots land on row m, dropped)."""
    import torch
    y = torch.zeros((m + 1, y_slots.shape[1]), dtype=torch.float32,
                    device=y_slots.device)
    return y.index_add_(0, sc.row_perm.long(), y_slots)[:m]


def k1_plan_line(name: str, sc) -> None:
    """K1's work plan for the stream as ``sellcs_spmm`` uses it (built at
    the first launch, kept on ``slice_ptr``): build seconds, bytes, items,
    combine segments and scratch rows, and the stream's deepest slice."""
    from repro_torch.spmm import slots_plan as SP
    plan = SP.cached_slots_plan(sc.slice_ptr, num_slices=sc.num_slices,
                                chunk=sc.chunk, row_len=sc.row_len)
    widths = sc.slice_ptr[1:] - sc.slice_ptr[:-1]
    print(f"[chip_smoke]   K1 plan on {name}: build {plan.build_s:.4f} s, "
          f"{plan.nbytes()} bytes, {plan.n_items} items of depth <= "
          f"{plan.depth}, {plan.n_segs} combine segments, "
          f"{plan.n_scratch} scratch rows; deepest slice "
          f"{int(widths.max())} width-rows, deepest group walk "
          f"{plan.deepest}", flush=True)


def check_kernels(name: str, scale: float, ks, reps: int, table: dict,
                  shape_rows: list, main: bool):
    """Phase 2 on one matrix: every kernel against its plain version.
    Returns the matrix and its SELL-C-σ stream for the main matrix (the
    mesh phase reuses them), else None."""
    import torch
    from repro_torch.core import coo_to_csr
    from repro_torch.data import matrices
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.kernels import ops as KO
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
    for k in tuple(ks) + K2_ONLY_KS:
        only_k2 = k not in ks
        X = torch.randn((n, k), generator=gen, device="cuda")
        lib_ms = cuda_ms(lambda: A_lib @ X, reps)
        rows = []

        # K1, as sellcs_spmm launches it (each lane stops at its row_len)
        def k1():
            return SK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X,
                                   num_slices=S, chunk=C, row_len=sc.row_len)

        def k1p():
            return SK.sellcs_slots_plain(sc.data, sc.cols, sc.slice_ptr, X,
                                         num_slices=S, chunk=C,
                                         row_len=sc.row_len)
        if not only_k2:
            yk, yp = k1(), k1p()
            again = k1()
            torch.cuda.synchronize()
            if not torch.equal(yk, again):
                raise AssertionError(f"K1 is not deterministic on {name} "
                                     f"k={k}")
            if k == ks[0]:
                k1_plan_line(name, sc)
            b, by = bound_ms(spmm_bytes(nnz, m, n, k), 2.0 * nnz * k)
            rows.append(("K1", max_err(yk, yp), tol_of(yp),
                         cuda_ms(k1, reps), cuda_ms(k1p, max(reps // 2, 1)),
                         b, by, lib_ms,
                         {"unpermute_ms": cuda_ms(
                             lambda: unpermute(sc, yk, m), reps),
                          "prev_ms": PREV_MS.get((name, k, "K1"))}))
            del again
            if k == 1:
                # a call of tens of microseconds: the host's issue time
                # against the card's
                bd = launch_breakdown(k1)
                print(f"[chip_smoke]   K1 breakdown on {name}: "
                      f"{breakdown_text(bd)}", flush=True)
                rows[-1][-1]["breakdown"] = bd

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
                         cuda_ms(lambda: At_lib @ Xm, reps),
                         {"bands": SK.column_bands(
                             n, k, props_l2()), "prev_ms": PREV_MS.get(
                                 (name, k, "K3"))}))
            if main and k == MAIN_K:
                shape_rows.append(k3_breakdown(name, sc, xs, n, k, reps, yp))
            # the whole A^T X multiply (slot-X gather + K3) against the oracle
            yt = SK.sellcs_spmm(sc, Xm, op="T")
            ref_t = spmm_coo_t(coo, Xm)
            err_t = max_err(yt, ref_t)
            if err_t > tol_of(ref_t):
                raise AssertionError(f"A^T X (gather + K3) vs oracle on "
                                     f"{name} k={k}: {err_t:.3g}")
            t_ms = cuda_ms(lambda: SK.sellcs_spmm(sc, Xm, op="T"), reps)
            print(f"[chip_smoke]   A^T X k={k:<2} (gather + K3) {t_ms:.4f} "
                  f"ms, vs oracle max_abs_err={err_t:.3g}", flush=True)
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
        again = k2()
        torch.cuda.synchronize()
        if not torch.equal(crk, crp):
            raise AssertionError(f"K2 carry rows differ on {name} k={k}")
        if not all(torch.equal(u, v) for u, v in zip((yk, crk, cvk), again)):
            raise AssertionError(f"K2 is not deterministic on {name} k={k}")
        del again
        err2 = max(max_err(yk, yp), max_err(cvk, cvp))
        carry_bytes = 2 * P * (4 + 4 * k)
        b, by = bound_ms(spmm_bytes(nnz, m, n, k), 2.0 * nnz * k)
        # the C entry zeroes all of Y before the launch: its cost alone
        zscratch = torch.empty_like(yk)
        rows.append(("K2", err2, tol_of(yp), cuda_ms(k2, reps),
                     cuda_ms(k2p, max(reps // 2, 1)), b, by, lib_ms,
                     {"gather_bound_ms": gather_bound_ms(nnz, m, n, k),
                      "zero_y_ms": cuda_ms(zscratch.zero_, reps),
                      "prev_ms": PREV_MS.get((name, k, "K2"))}))
        del zscratch
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

        def fix():
            return MS.carry_out_fixup(scratch, crk, cvk)

        def lib_fix():
            return scratch.index_add_(0, rows_kept, vals_kept)
        rows.append(("carry", max_err(fk, fp), tol_of(fp),
                     cuda_ms(fix, reps),
                     cuda_ms(lambda: MS.carry_out_fixup_plain(
                         scratch, crk, cvk), reps), b, by,
                     cuda_ms(lib_fix, reps),
                     {"device_ms": device_ms(fix),
                      "library_device_ms": device_ms(lib_fix),
                      "prev_ms": PREV_MS.get((name, k, "carry"))}))
        # the whole merge multiply against the torch oracle
        err_ref = max_err(fk, spmm_csr(csr, X))
        if err_ref > tol_of(fk):
            raise AssertionError(f"merge K2+carry vs oracle on {name} "
                                 f"k={k}: {err_ref:.3g}")
        # csr_spmm: K2 and the carry step from one C entry call
        shape_rows.append(merge_multiply_row(
            name, k, "csr_spmm", lambda: SK.csr_spmm(csr, X),
            lambda: MS.carry_out_fixup(*SK._merge_spmm_partials(plan, X, m)),
            MS.carry_out_fixup_plain(yp.clone(), crp, cvp),
            SHORT_REPS if k == 1 else 50))
        del scratch, rows_kept, vals_kept, fk, fp

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
            rows.append(("K4", err4, tol_of(yp),
                         cuda_ms(k4, SHORT_REPS),
                         cuda_ms(k4p, max(reps // 2, 1)), b, by,
                         cuda_ms(lambda: A_lib @ X, SHORT_REPS),
                         {"plan_bound_ms": plan_bound_ms(plan, m, n),
                          "prev_ms": PREV_MS.get((name, 1, "K4"))}))
            bd = launch_breakdown(k4)
            bl = launch_breakdown(lambda: A_lib @ X)
            print(f"[chip_smoke]   K4 breakdown on {name}: "
                  f"{breakdown_text(bd)}; library {breakdown_text(bl)}",
                  flush=True)
            rows[-1][-1].update(breakdown=bd, library_breakdown=bl)
            # ops.merge_spmv: K4 and the carry step from one C entry call
            shape_rows.append(merge_multiply_row(
                name, 1, "merge_spmv", lambda: KO.merge_spmv(csr, x1),
                lambda: MS.carry_out_fixup(*MS.merge_spmv_partials(plan, x1,
                                                                   m)),
                MS.carry_out_fixup_plain(yp.clone(), crp, cvp)[:, 0],
                SHORT_REPS))

        for kern, err, tol, ms, pms, b, by, lms, *more in rows:
            extra = more[0] if more else {}
            ok = err <= tol
            print(f"[chip_smoke]   {kern:<5} k={k:<2} max_abs_err={err:.3g} "
                  f"tol={tol:.3g} {'ok' if ok else 'FAIL'} kernel_ms={ms:.4f}"
                  f" plain_ms={pms:.4f} bound_ms={b:.4f} ({by}) library_ms="
                  f"{'null' if lms is None else f'{lms:.4f}'}" + "".join(
                      f" {key}={v if v is None else f'{v:.4f}'}"
                      for key, v in extra.items()
                      if not isinstance(v, dict)), flush=True)
            if not ok:
                raise AssertionError(f"{kern} disagrees with its plain "
                                     f"version on {name} k={k}: {err:.3g} "
                                     f"> {tol:.3g}")
            shape_rows.append({"matrix": name, "scale": scale, "k": k,
                               "kernel": kern, "max_abs_err": err,
                               "tol": tol, "ms": ms, "plain_ms": pms,
                               "bound_ms": b, "library_ms": lms, **extra})
            want_k = 1 if kern == "K4" else MAIN_K
            if main and k == want_k:
                table[kern] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                               "bound_ms": b, "bound_by": by,
                               "library_ms": lms, **extra}
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
    the library's CSR multiply and both bounds. K6 reads the stream once
    whatever its column tile is, so only ``choose_k_tile``'s is timed; a
    narrower one is checked against the plain version."""
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
        stream_gb = tile_stream_bytes(ts) / 1e9
        for kern, kt, kfn, pfn in cases:
            yk, yp = kfn(), pfn()
            torch.cuda.synchronize()
            err, tol = max_err(yk, yp), tol_of(yp)
            if kt not in (kt0, k):
                print(f"[chip_smoke]   {label} {kern} k={k:<2} kt={kt:<2} "
                      f"max_abs_err={err:.3g} tol={tol:.3g} "
                      f"{'ok' if err <= tol else 'FAIL'} (the launch of "
                      f"kt={kt0}, not timed)", flush=True)
                if err > tol:
                    raise AssertionError(f"{kern} disagrees with its plain "
                                         f"version on {label} k={k} kt={kt}:"
                                         f" {err:.3g} > {tol:.3g}")
                out.append({"matrix": label, "k": k, "kernel": kern,
                            "k_tile": kt, "max_abs_err": err, "tol": tol})
                continue
            ms = cuda_ms(kfn, reps)
            pms = cuda_ms(pfn, max(reps // 2, 1))
            ok = err <= tol
            prev = PREV_MS.get((label, k, kern))
            print(f"[chip_smoke]   {label} {kern} k={k:<2} kt={kt:<2} "
                  f"max_abs_err={err:.3g} tol={tol:.3g} "
                  f"{'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} plain_ms="
                  f"{pms:.4f} bound_ms={b:.4f} ({by}) stream_bound_ms="
                  f"{sb:.4f} library_ms={lib_ms:.4f} prev_ms={prev} "
                  f"tile_GB/s={stream_gb / (ms * 1e-3):.1f}", flush=True)
            if not ok:
                raise AssertionError(f"{kern} disagrees with its plain "
                                     f"version on {label} k={k} kt={kt}: "
                                     f"{err:.3g} > {tol:.3g}")
            row = {"matrix": label, "k": k, "kernel": kern, "k_tile": kt,
                   "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": pms,
                   "bound_ms": b, "bound_by": by, "stream_bound_ms": sb,
                   "library_ms": lib_ms, "prev_ms": prev,
                   "tile_gb_per_s": stream_gb / (ms * 1e-3),
                   "nnz_per_tile": ts.nnz / max(ts.num_tiles, 1)}
            out.append(row)
            if main and k == MAIN_K and kern not in table:
                table[kern] = row
        del X, y6, y7, ref
    return out


def k67_breakdown(label: str, ts, ks, reps: int) -> list:
    """Where K7's time goes, through its wrapper alone: the multiply
    beside the same launch on a copy of the stream whose tiles are all
    zero (the same tile bytes, indices and X pre-pass, no nonzero to walk
    and no sum to add into Y), and the zeroing of Y inside the wrapper."""
    import dataclasses
    import torch
    from repro_torch.kernels import bsr_spmv as BS
    n = ts.shape[1]
    mp, _ = ts.padded_shape()
    zero = dataclasses.replace(ts, tiles=torch.zeros_like(ts.tiles))
    out = []
    for k in ks:
        X = torch.randn((n, k), generator=torch.Generator(
            device="cuda").manual_seed(79), device="cuda")
        if bool(BS.bsr_spmm(zero, X).any()):
            raise AssertionError(f"K7 on zero tiles gave nonzeros ({label})")
        row = {"matrix": label, "k": k,
               "kernel_ms": cuda_ms(lambda: BS.bsr_spmm(ts, X), reps),
               "zero_tiles_ms": cuda_ms(lambda: BS.bsr_spmm(zero, X), reps),
               "zero_y_ms": cuda_ms(lambda: torch.zeros((mp, k),
                                                        device="cuda"), reps)}
        print(f"[chip_smoke]   {label} K7 breakdown k={k}: " + ", ".join(
            f"{key} {v:.4f}" for key, v in row.items() if key.endswith("_ms")),
            flush=True)
        out.append(row)
    del zero
    return out


def nonfinite_rows(label: str, ts, k: int) -> list:
    """K6 and K7 against their plain versions for an X with a NaN and an
    Inf, and K5 for its first column with the same Inf: each must reach
    the same outputs (every row of every stored tile over their 128-row X
    blocks, through the stored zeros), and the finite outputs agree within
    the usual tolerance."""
    import torch
    from repro_torch.kernels import bsr_spmv as BS
    from repro_torch.spmm import kernels as SK
    n = ts.shape[1]
    X = torch.randn((n, k), generator=torch.Generator(
        device="cuda").manual_seed(78), device="cuda")
    X[n // 3, 0] = float("nan")
    X[2 * n // 3, k - 1] = float("inf")
    x = X[:, 0].clone()
    x[2 * n // 3] = float("inf")
    out = []
    for kern, kfn, pfn in (
            ("K6", lambda: SK.tiled_spmm(ts, X),
             lambda: SK.tiled_spmm_plain(ts, X)),
            ("K7", lambda: BS.bsr_spmm(ts, X),
             lambda: BS.bsr_spmm_plain(ts, X)),
            ("K5", lambda: BS.bsr_spmv(ts, x),
             lambda: BS.bsr_spmv_plain(ts, x))):
        yk, yp = kfn(), pfn()
        torch.cuda.synchronize()
        fin = yp.isfinite()
        same = (torch.equal(yk.isnan(), yp.isnan())
                and torch.equal(yk.isinf(), yp.isinf())
                and torch.equal(yk[yk.isinf()], yp[yp.isinf()]))
        err, tol = max_err(yk[fin], yp[fin]), tol_of(yp[fin])
        print(f"[chip_smoke]   {label} {kern} k={1 if kern == 'K5' else k} "
              f"non-finite X: "
              f"{int(yp.isnan().sum())} NaN, {int(yp.isinf().sum())} Inf "
              f"outputs, same places {same}, finite max_abs_err={err:.3g} "
              f"tol={tol:.3g}", flush=True)
        if not same or err > tol or not bool((~fin).any()):
            raise AssertionError(f"{kern} disagrees with its plain version "
                                 f"on {label} with a non-finite X")
        out.append({"matrix": label, "k": 1 if kern == "K5" else k,
                    "kernel": kern, "nan": int(yp.isnan().sum()),
                    "inf": int(yp.isinf().sum()), "same_places": same,
                    "max_abs_err": err, "tol": tol})
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
    lib1 = cuda_ms(lambda: A_lib @ x[:, None], SHORT_REPS)
    lib1_bd = launch_breakdown(lambda: A_lib @ x[:, None])
    print(f"[chip_smoke]   library (CSR) k = 1: {breakdown_text(lib1_bd)}",
          flush=True)
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
        # K5's zero-free operand: built once here (its own seconds), kept
        # on the tiles and reused by every K5 launch below
        op = BS._compact_tiles(ts)
        xsw, ysw = ts.window_switches()
        y, counts = run_counted(lambda: spmv(ts, x))
        if counts["K5"] != 1:
            raise AssertionError(f"spmv on the {algo} tiles launched K5 "
                                 f"{counts['K5']} times")
        if ts._compact is not op:
            raise AssertionError(f"K5 rebuilt its operand on {algo}")
        launches["K5"] += 1
        err_ref = max_err(y, ref1)
        if err_ref > tol_of(ref1):
            raise AssertionError(f"K5 ({algo}) vs oracle: {err_ref:.3g}")
        yp = BS.bsr_spmv_plain(ts, x)
        err, tol = max_err(y, yp), tol_of(yp)
        if err > tol:
            raise AssertionError(f"K5 disagrees with its plain version on "
                                 f"{algo}: {err:.3g} > {tol:.3g}")
        ms = cuda_ms(lambda: BS.bsr_spmv(ts, x), SHORT_REPS)
        pms = cuda_ms(lambda: BS.bsr_spmv_plain(ts, x), max(reps // 2, 1))
        sb, cb = stream_bound_ms(ts, 1), compact_bound_ms(ts, op)
        prev = PREV_MS.get((f"road_like/{algo}", 1, "K5"))
        bd = launch_breakdown(lambda: BS.bsr_spmv(ts, x))
        row = {"matrix": "road_like", "scale": scale_road, "order": algo,
               "num_bands": bands, "convert_s": conv_s,
               "compact_build_s": op.build_s, "compact_bytes": op.nbytes(),
               "tiles": ts.num_tiles, "fill": ts.fill_ratio,
               "x_switches": xsw, "y_switches": ysw, "kernel": "K5",
               "max_abs_err": err, "tol": tol, "oracle_err": err_ref,
               "ms": ms, "plain_ms": pms, "bound_ms": b1, "bound_by": by1,
               "stream_bound_ms": sb, "compact_bound_ms": cb,
               "library_ms": lib1, "prev_ms": prev, "breakdown": bd}
        orders.append(row)
        if "K5" not in table:
            table["K5"] = row
        print(f"[chip_smoke]   {algo:<8} convert {conv_s:.2f} s (+ K5 "
              f"operand {op.build_s:.3f} s, {op.nbytes() / 1e6:.1f} MB), "
              f"tiles {ts.num_tiles}, fill {ts.fill_ratio:.4f}, switches "
              f"x={xsw} y={ysw}; K5 {ms:.4f} ms (plain {pms:.4f}, bound "
              f"{b1:.4f}, operand {cb:.4f}, tile stream {sb:.4f}, library "
              f"{lib1:.4f}, before {prev}) max_abs_err {err:.3g}; "
              f"{breakdown_text(bd)}", flush=True)
        del ts, y, yp, op
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
        if algo == "csb":
            nonfinite = nonfinite_rows(f"road_like/{algo}", ts, MAIN_K)
            breakdown = k67_breakdown(f"road_like/{algo}", ts, (MAIN_K, 8),
                                      reps)
        del ts
        torch.cuda.empty_cache()
    del A_lib
    torch.cuda.empty_cache()

    # mawi_like: the dense row spread over thousands of tiles of one row
    t0 = time.perf_counter()
    mawi = matrices.as_coo(
        matrices.test_suite(scale_mawi)["mawi_like"].make(), device="cuda")
    ts = coo_to_tiled(mawi, "csb")
    op = BS._compact_tiles(ts)
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
               "compact_build_s": op.build_s, "compact_bytes": op.nbytes(),
               "ms": cuda_ms(lambda: BS.bsr_spmv(ts, xm), SHORT_REPS),
               "plain_ms": cuda_ms(lambda: BS.bsr_spmv_plain(ts, xm), 1),
               "bound_ms": bm, "bound_by": bym,
               "stream_bound_ms": stream_bound_ms(ts, 1),
               "compact_bound_ms": compact_bound_ms(ts, op),
               "library_ms": cuda_ms(lambda: M_lib @ xm[:, None],
                                     SHORT_REPS),
               "prev_ms": PREV_MS.get(("mawi_like/csb", 1, "K5")),
               "breakdown": launch_breakdown(lambda: BS.bsr_spmv(ts, xm))}
    print(f"[chip_smoke]   mawi_like K5 {mawi_k5['ms']:.4f} ms (plain "
          f"{mawi_k5['plain_ms']:.4f}, bound {bm:.4f}, operand "
          f"{mawi_k5['compact_bound_ms']:.4f}, tile stream "
          f"{mawi_k5['stream_bound_ms']:.4f}, library "
          f"{mawi_k5['library_ms']:.4f}, before {mawi_k5['prev_ms']}) "
          f"max_abs_err {errm:.3g}; operand {op.build_s:.3f} s, "
          f"{op.nbytes() / 1e6:.1f} MB; "
          f"{breakdown_text(mawi_k5['breakdown'])}", flush=True)
    spmm_rows.append(mawi_k5)
    spmm_rows += tiled_rows("mawi_like/csb", mawi, ts, (MAIN_K,),
                            lambda k, kt0: [kt0], reps, M_lib, launches,
                            table, main=False)
    del ts, op, mawi, M_lib, ym, ypm, refm
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
    return {"orders": orders, "library_breakdown": lib1_bd,
            "spmm": spmm_rows, "nonfinite": nonfinite,
            "k67_breakdown": breakdown, "serve": serve_row,
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
        # as the mesh's _local_slots launches it: the shard's row_len
        # window and depth base
        kw = dict(num_slices=sh.num_slices, chunk=sharded.chunk,
                  col_map=sh.col_map, row_len=sh.t_row_len,
                  depth_ptr=sh.t_ptr)

        def kern():
            return SK.sellcs_slots(sh.data, sh.cols, sh.slice_ptr, X, **kw)

        def plain():
            return SK.sellcs_slots_plain(sh.data, sh.cols, sh.slice_ptr, X,
                                         **kw)
        yk, yp = kern(), plain()
        # K1 on the up-front slab X[col_map], over the same plan
        # (uncounted: a comparison, not the path)
        y1 = torch.empty_like(yk)
        SK._sellcs_slots_launch(
            SK._slots.cached_slots_plan(
                sh.slice_ptr, num_slices=sh.num_slices,
                chunk=sharded.chunk, row_len=sh.t_row_len,
                depth_ptr=sh.t_ptr), sh.data, sh.cols,
            X.index_select(0, sh.col_map), y1)
        torch.cuda.synchronize()
        err, tol = max_err(yk, yp), tol_of(yp)
        if err > tol:
            raise AssertionError(f"K8 disagrees with its plain version on "
                                 f"shard {p}: {err:.3g} > {tol:.3g}")
        if not torch.equal(yk, y1):
            raise AssertionError(f"K8 on shard {p} is not bitwise K1 on "
                                 "the up-front slab")
        A_p, rows_p, nnz_p = _shard_csr(coo, sharded, p)
        nbytes = (nnz_p * 8 + (rows_p + 1) * 4
                  + sh.n_touched * (k * 4 + 4) + rows_p * k * 4)
        b, by = bound_ms(nbytes, 2.0 * nnz_p * k)
        row = {"shard": p, "rows": rows_p, "nnz": nnz_p,
               "n_touched": sh.n_touched, "max_abs_err": err, "tol": tol,
               "ms": cuda_ms(kern, reps),
               "plain_ms": cuda_ms(plain, max(reps // 2, 1)),
               "library_ms": cuda_ms(lambda: A_p @ X, reps),
               "bound_ms": b, "bound_by": by,
               "prev_ms": PREV_K8_MS[p] if p < len(PREV_K8_MS) else None}
        out["shards"].append(row)
        for key in ("ms", "plain_ms", "library_ms"):
            out[key] += row[key]
        out["bound_bytes"] += nbytes
        out["flops"] += 2.0 * nnz_p * k
        out["max_abs_err"] = max(out["max_abs_err"], err)
        print(f"[chip_smoke]   K8 shard {p}: rows {rows_p} nnz {nnz_p} "
              f"touched {sh.n_touched} max_abs_err={err:.3g} tol={tol:.3g} "
              f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={b:.4f} ({by})"
              f" prev_ms={row['prev_ms']}; bitwise the up-front slab",
              flush=True)
        del A_p, yk, yp, y1
    out["bound_ms"], out["bound_by"] = bound_ms(out["bound_bytes"],
                                                out["flops"])
    out["prev_ms"] = sum(PREV_K8_MS)
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
    for label in ("row/cx", "merge4"):
        rows.append(k3_shard_rows(parts[label], Xt, label))
    print(f"[chip_smoke]   single-device K1 at k={MAIN_K}: {k1_ms:.4f} ms "
          "(phase 2)", flush=True)
    k8 = k8_rows(coo, parts["row/cx"], X, reps)
    print(f"[chip_smoke]   K8 over {MESH_P} shards: {k8['ms']:.4f} ms "
          f"(plain {k8['plain_ms']:.4f}, library {k8['library_ms']:.4f}, "
          f"bound {k8['bound_ms']:.4f} {k8['bound_by']}, prev "
          f"{k8['prev_ms']:.4f})", flush=True)
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
                "per_shard_ms": [r["ms"] for r in k8["shards"]],
                "prev_ms": k8["prev_ms"]}
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
    step of T = 32. Two figures: the flops as f32 FMAs at the f32 peak
    (the SIMT kernels), and as the exact split's three bf16 products at
    the bf16 tensor-core peak (the tensor-core kernel)."""
    d, f, E, top = (GRANITE[k] for k in ("d", "f", "E", "top"))
    out = []
    for tokens in (4096, 32):
        nbytes = flops = 0.0
        for kin, nout in ((d, f), (d, f), (f, d)):
            b, fl = k9_gemm_work(tokens * top, kin, nout, E, 2)
            nbytes += b
            flops += fl
        bms, by = bound_ms(nbytes, flops)
        sms, sby = bound_ms(nbytes, 3 * flops, PEAK_FLOPS_BF16)
        out.append({"tokens": tokens, "bytes": nbytes, "flops": flops,
                    "bound_ms": bms, "bound_by": by,
                    "split_bound_ms": sms, "split_bound_by": sby})
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


def k9_operands(rows: int, E: int, kin: int, nout: int, lhs_dtype, gen,
                sizes):
    """Tokens, zero-padded weights and the group padding of one K9 case."""
    import torch
    from repro_torch.kernels import ops as KO
    kp = -(-kin // 128) * 128
    np_ = -(-nout // 128) * 128
    xs = torch.randn((rows, kin), generator=gen, device="cuda").to(lhs_dtype)
    w = torch.randn((E, kp, np_), generator=gen, device="cuda") * kin ** -0.5
    w[:, kin:] = 0.0
    w[:, :, nout:] = 0.0
    return xs, w, KO.moe_group_pad(xs, sizes, E, kp)


def k9_f64_err(gp, w, n_live: int, outs) -> list:
    """The largest error of each output in ``outs`` on the live tiles
    against the product computed in float64 (every lhs and weight value
    is exact in float64; 16 tiles a batched product)."""
    import torch
    kp = int(w.shape[1])
    a = gp.lhs[:n_live * 128].double().view(n_live, 128, kp)
    te = gp.tile_expert[:n_live].long()
    errs = [0.0] * len(outs)
    for t0 in range(0, n_live, 16):
        sl = slice(t0, min(t0 + 16, n_live))
        ref = torch.bmm(a[sl], w[te[sl]].double()).reshape(-1, w.shape[2])
        rows = slice(t0 * 128, sl.stop * 128)
        for i, o in enumerate(outs):
            errs[i] = max(errs[i], float((o[rows].double() - ref).abs()
                                         .max()))
    return errs


def k9_case(label, tokens: int, E: int, top: int, kin: int, nout: int,
            lhs_dtype, reps: int, gen, empty: int = 0, sizes=None) -> dict:
    """K9 on one grouped GEMM: the group padding of ``kernels.ops`` over
    skewed group sizes (or ``sizes``) through every K9 kernel that takes
    the operands — the SIMT tiled kernel, the tensor-core kernel (bf16
    rows) and the decode kernel (decode-sized: at most 512 rows) — each
    against the plain version on the real rows and timed, with the plain
    version's time, the bound and the library yardstick: ``torch.bmm`` of
    the live m-tiles (f32) by their experts' weights, both gathered
    outside the timed window (no single PyTorch call takes per-tile expert
    ids). ``route`` names the kernel ``kernels.ops.moe_group_matmul``
    takes for these shapes and dtype, and ``ms`` is its time. The decode
    kernel must equal the tiled kernel bitwise (both given the tiles' row
    counts, and on the live rows without them). For the tensor-core
    kernel on prefill shapes, its and the tiled kernel's largest error
    against the float64 product are kept; its bound is the split
    product's (three bf16 products at the bf16 tensor-core rate), with
    the float32 FMA bound beside it."""
    import torch
    from repro_torch.kernels import moe_group_matmul as MG
    from repro_torch.kernels import ops as KO
    if sizes is None:
        sizes = skewed_sizes(tokens, E, top, gen, empty)
    rows = tokens * top
    xs, w, gp = k9_operands(rows, E, kin, nout, lhs_dtype, gen, sizes)
    kp = int(w.shape[1])
    bf16 = lhs_dtype == torch.bfloat16
    small = rows <= 512
    route = ("wgmma" if bf16 else "decode"
             if KO.takes_decode_kernel(rows, E, lhs_dtype) else "tiled")

    def tiled():
        return MG.moe_group_matmul_padded(gp.lhs, w, gp.tile_expert,
                                          n_rows=gp.n_rows)

    def dec():
        return MG.moe_group_matmul_decode(gp.lhs, w, gp.tile_expert,
                                          gp.tile_rows, n_rows=gp.n_rows)

    def wg():
        return MG.moe_group_matmul_wgmma(gp.lhs, w, gp.tile_expert,
                                         n_rows=gp.n_rows)

    def plain():
        return MG.moe_group_matmul_padded_plain(gp.lhs, w, gp.tile_expert,
                                                n_rows=gp.n_rows,
                                                tile_rows=gp.tile_rows)
    kerns = {"tiled": tiled}
    if bf16:
        kerns["wgmma"] = wg
    if small:
        kerns["decode"] = dec
    yp = plain()
    outs = {name: fn() for name, fn in kerns.items()}
    torch.cuda.synchronize()
    live = (torch.arange(128, device="cuda")[None, :]
            < gp.tile_rows[:, None]).reshape(-1)
    # the plain version zeroes the rows past the tiles' counts: kernels
    # not given the counts are held to it on the real rows
    errs = {name: max_err(o[live], yp[live]) for name, o in outs.items()}
    tol = tol_of(yp)
    bitwise = None
    if small:
        yt2 = MG.moe_group_matmul_padded(gp.lhs, w, gp.tile_expert,
                                         n_rows=gp.n_rows,
                                         tile_rows=gp.tile_rows)
        bitwise = bool(torch.equal(outs["decode"], yt2)) and bool(
            torch.equal(outs["decode"][live], outs["tiled"][live]))
        del yt2
    n_live = int(gp.n_rows) // 128
    err64 = None
    if bf16 and not small:
        e_w, e_t = k9_f64_err(gp, w, n_live, (outs["wgmma"], outs["tiled"]))
        err64 = {"wgmma": e_w, "tiled": e_t}
    del outs
    # the whole ops-level multiply (padding, K9, unpadding) against the
    # per-token oracle on the unpadded operands
    from repro_torch.kernels.ref import moe_group_matmul_ref
    full = KO.moe_group_matmul(xs, w[:, :kin, :nout], sizes)
    # (the oracle gathers a weight block per row: decode sizes only)
    err_ref = (max_err(full, moe_group_matmul_ref(xs, w[:, :kin, :nout],
                                                  sizes))
               if small else None)
    a_lib = gp.lhs[:n_live * 128].float().view(n_live, 128, kp)
    w_lib = w[gp.tile_expert[:n_live].long()]
    lib_ms = cuda_ms(lambda: torch.bmm(a_lib, w_lib), reps)
    n_used = int((sizes > 0).sum())
    nbytes, flops = k9_gemm_work(rows, kin, nout, n_used,
                                 xs.element_size())
    f32_b, f32_by = bound_ms(nbytes, flops)
    split_b, split_by = bound_ms(nbytes, 3 * flops, PEAK_FLOPS_BF16)
    times = {f"{name}_ms": cuda_ms(fn, reps) for name, fn in kerns.items()}
    row = {"case": label, "tokens": tokens, "rows": rows, "K": kin,
           "N": nout, "experts": E, "experts_used": n_used,
           "lhs_dtype": str(lhs_dtype).replace("torch.", ""),
           "t_pad": int(gp.lhs.shape[0]), "live_tiles": n_live,
           "route": route, "ms": times[f"{route}_ms"],
           "max_abs_err": errs[route], "tol": tol,
           **{f"{name}_err": e for name, e in errs.items()}, **times,
           "oracle_err": err_ref, "f64_err": err64,
           "bitwise_vs_tiled": bitwise,
           "plain_ms": cuda_ms(plain, max(reps // 2, 1)),
           "f32_fma_bound_ms": f32_b, "f32_fma_bound_by": f32_by,
           "split_bound_ms": split_b, "split_bound_by": split_by,
           "bytes": nbytes, "flops": flops, "library_ms": lib_ms,
           "max_group": int(sizes.max()), "empty_groups": E - n_used}
    del a_lib, w_lib, full, yp, gp, w, xs
    torch.cuda.empty_cache()
    ok = all(e <= tol for e in errs.values()) \
        and (err_ref is None or err_ref <= tol) and bitwise is not False
    print(f"[chip_smoke]   K9 {label:<18} rows={rows} K={kin} N={nout} "
          f"used={n_used}/{E} max_group={row['max_group']} live_tiles="
          f"{n_live} route={route} errors " + " ".join(
              f"{k}={v:.3g}" for k, v in errs.items())
          + f" tol={tol:.3g} oracle_err={err_ref} f64_err={err64} "
          f"bitwise_vs_tiled={bitwise} {'ok' if ok else 'FAIL'} ms "
          + " ".join(f"{k}={v:.4f}" for k, v in times.items())
          + f" plain_ms={row['plain_ms']:.4f} bound_ms f32 FMA {f32_b:.4f}"
          f" ({f32_by}), split {split_b:.4f} ({split_by}) library_ms="
          f"{lib_ms:.4f}", flush=True)
    if not ok:
        raise AssertionError(f"K9 disagrees on {label}: {errs} / "
                             f"{err_ref} > {tol:.3g}, bitwise {bitwise}")
    return row


# rows per expert of the crossover sweep (uniform groups at granite's
# gate/up shape, 32 experts)
K9_SWEEP = (4, 8, 16, 24, 32, 48, 64, 96, 128)


def k9_crossover(reps: int, gen) -> list:
    """The three K9 kernels at granite's gate/up shape (K 1024, N 512, 32
    experts, bf16 rows) with every group ``g`` rows, for ``g`` in
    ``K9_SWEEP``, called as ``kernels.ops.moe_group_matmul`` calls them:
    where the decode kernel stops being faster than the tensor-core kernel
    (``kernels.ops.DECODE_ROWS_PER_EXPERT`` is set from it), with the SIMT
    tiled kernel beside them. Each time is one call's device time
    (``device_ms``): at these sizes the host takes about as long to issue
    a call. The decode and tiled kernels must agree bitwise at every
    ``g``, the tensor-core kernel with them within the tolerance."""
    import torch
    from repro_torch.kernels import moe_group_matmul as MG
    d, f, E = GRANITE["d"], GRANITE["f"], GRANITE["E"]
    out = []
    for g in K9_SWEEP:
        sizes = torch.full((E,), g, dtype=torch.int64, device="cuda")
        xs, w, gp = k9_operands(g * E, E, d, f, torch.bfloat16, gen, sizes)

        def tiled():
            return MG.moe_group_matmul_padded(gp.lhs, w, gp.tile_expert,
                                              n_rows=gp.n_rows)

        def dec():
            return MG.moe_group_matmul_decode(gp.lhs, w, gp.tile_expert,
                                              gp.tile_rows, n_rows=gp.n_rows)

        def wg():
            return MG.moe_group_matmul_wgmma(gp.lhs, w, gp.tile_expert,
                                             n_rows=gp.n_rows)
        yt, yd = tiled(), dec()
        live = (torch.arange(128, device="cuda")[None, :]
                < gp.tile_rows[:, None]).reshape(-1)
        if not torch.equal(yt[live], yd[live]):
            raise AssertionError(f"K9 decode kernel is not bitwise equal to "
                                 f"the tiled kernel at {g} rows an expert")
        err = max_err(wg()[live], yt[live])
        if err > tol_of(yt):
            raise AssertionError(f"K9 tensor-core kernel vs tiled at {g} "
                                 f"rows an expert: {err:.3g}")
        row = {"rows_per_expert": g, "tiled_ms": device_ms(tiled),
               "decode_ms": device_ms(dec), "wgmma_ms": device_ms(wg),
               "wgmma_err": err}
        out.append(row)
        del xs, w, gp, yt, yd
    torch.cuda.empty_cache()
    print("[chip_smoke]   K9 crossover (gate/up, 32 experts, rows an "
          "expert: tiled / decode / tensor-core device ms): " + ", ".join(
              f"{r['rows_per_expert']}: {r['tiled_ms']:.4f} / "
              f"{r['decode_ms']:.4f} / {r['wgmma_ms']:.4f}" for r in out),
          flush=True)
    return out


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
    # every token picks experts 0..7: eight groups of exactly 32 rows
    full = torch.zeros(E, dtype=torch.int64, device="cuda")
    full[:top] = LM_BATCH
    cases.append(k9_case("decode/groups_of_32", LM_BATCH, E, top, d, f,
                         torch.bfloat16, reps, gen, sizes=full))
    cases.append(k9_case("decode/f32", LM_BATCH, E, top, d, f,
                         torch.float32, reps, gen))
    cases.append(k9_case("reduced/f32", 64, 8, 4, 64, 64, torch.float32,
                         reps, gen))
    crossover = k9_crossover(reps, gen)

    def layer(label, key):
        """One MoE layer's three launches: gate and up (one shape) and
        down, summed."""
        by = {c["case"]: c for c in cases}
        return 2 * by[f"{label}/gate_up"][key] + by[f"{label}/down"][key]

    def worst(key):
        return max(c[key] for c in cases if key in c)

    # the kernels line: K9's entry is its SIMT kernels (the tiled one on
    # one MoE layer of the served prefill, the decode kernel on one decode
    # step's layer), at the f32 FMA bound; K9w the tensor-core kernel on
    # the same prefill layer at the split product's bound, with its
    # largest float64 error beside the tiled kernel's
    pre_b, pre_by = bound_ms(layer("prefill", "bytes"),
                             layer("prefill", "flops"))
    dec_b, _ = bound_ms(layer("decode", "bytes"), layer("decode", "flops"))
    table["K9"] = {
        "max_abs_err": max(worst("tiled_err"), worst("decode_err")),
        "ms": layer("prefill", "tiled_ms"),
        "plain_ms": layer("prefill", "plain_ms"), "bound_ms": pre_b,
        "bound_by": pre_by, "library_ms": layer("prefill", "library_ms"),
        "decode_ms": layer("decode", "decode_ms"),
        "decode_plain_ms": layer("decode", "plain_ms"),
        "decode_bound_ms": dec_b,
        "decode_library_ms": layer("decode", "library_ms"),
        "decode_tiled_ms": layer("decode", "tiled_ms")}
    split_b, split_by = bound_ms(layer("prefill", "bytes"),
                                 3 * layer("prefill", "flops"),
                                 PEAK_FLOPS_BF16)
    f64 = [c["f64_err"] for c in cases if c["f64_err"]]
    table["K9w"] = {
        "max_abs_err": worst("wgmma_err"),
        "ms": layer("prefill", "wgmma_ms"),
        "plain_ms": layer("prefill", "plain_ms"), "bound_ms": split_b,
        "bound_by": split_by, "f32_fma_bound_ms": pre_b,
        "library_ms": layer("prefill", "library_ms"),
        "f64_err": max(e["wgmma"] for e in f64),
        "tiled_f64_err": max(e["tiled"] for e in f64),
        "decode_ms": layer("decode", "wgmma_ms")}
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
    check_k9_launches(cfg, counts, torch.bfloat16)
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
    reduced = run_reduced_lm()
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
          "reduced_f32": reduced,
          "moe_layers": layers, "whole_model": whole, "profile": prof,
          "k9_cases": cases, "k9_crossover": crossover,
          "k9_bounds": bounds}
    print(f"[chip_smoke] serve --mode lm {cfg.name}: {cfg.n_layers} layers,"
          f" {res['n_params']} parameters; prefill {lm['prefill_ms']:.1f} ms"
          f", decode {lm['decode_ms_per_step']:.2f} ms/step "
          f"({res['tok_per_s']:.1f} tok/s); max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB; K9 launches {counts['K9']} tiled, "
          f"{counts['K9d']} decode, {counts['K9w']} tensor-core",
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


def check_k9_launches(cfg, counts, dtype) -> None:
    """The K9 launches of one ``serve --mode lm`` run (a prefill of
    LM_BATCH x LM_PROMPT tokens, LM_GEN - 1 decode steps of LM_BATCH) by
    ``ops.moe_group_matmul``'s rule for its activations' dtype: three
    grouped GEMMs a layer, each through the tensor-core kernel (bf16),
    the decode kernel (f32, few rows an expert) or the SIMT tiled kernel
    (f32); every other K9 kernel never."""
    import torch
    from repro_torch.kernels import ops as KO
    want = {"K9": 0, "K9d": 0, "K9w": 0}
    for tokens, calls in ((LM_BATCH * LM_PROMPT, 1), (LM_BATCH, LM_GEN - 1)):
        rows = tokens * cfg.top_k
        kern = ("K9w" if dtype == torch.bfloat16 else "K9d"
                if KO.takes_decode_kernel(rows, cfg.n_experts, dtype)
                else "K9")
        want[kern] += 3 * cfg.n_layers * calls
    for kern, n_want in want.items():
        if counts[kern] != n_want:
            raise AssertionError(f"serve --mode lm ({cfg.name}) launched "
                                 f"{kern} {counts[kern]} times, expected "
                                 f"{n_want}")


def run_reduced_lm() -> dict:
    """``serve --mode lm --reduced`` on the card: granite's reduced config
    computes in f32, so its prefill's MoE products take K9's SIMT tiled
    kernel and its decode steps' the decode kernel (the served path of
    those two kernels; bf16 activations take the tensor-core kernel)."""
    import torch
    from repro_torch.launch import serve
    res, counts = run_counted(lambda: serve.main(
        ["--mode", "lm", "--arch", "granite-moe-1b-a400m", "--reduced",
         "--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
         "--gen", str(LM_GEN), "--seed", "0", "--device", "cuda"]))
    cfg = res["cfg"]
    check_k9_launches(cfg, counts, cfg.compute_dtype)
    tok, logits = res["tokens"], res["prefill_logits"]
    if tok.shape != (LM_BATCH, LM_GEN) or not bool(
            ((tok >= 0) & (tok < cfg.vocab)).all()) or not bool(
                torch.isfinite(logits).all()):
        raise AssertionError("serve --mode lm --reduced: malformed output")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "prefill_ms": res["t_prefill"] * 1e3,
           "decode_ms_per_step": res["t_decode"] * 1e3 / (LM_GEN - 1),
           "launches": counts}
    print(f"[chip_smoke] serve --mode lm --reduced (f32): prefill "
          f"{out['prefill_ms']:.1f} ms, decode {out['decode_ms_per_step']:.2f}"
          f" ms/step; K9 launches {counts['K9']} tiled, {counts['K9d']} "
          f"decode, {counts['K9w']} tensor-core", flush=True)
    del res
    return out


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


class TraceError(Exception):
    """The profiler failed (not the call it traced)."""


def device_trace(fn):
    """(``[(kernel name, device us)]``, fn()) of one call under
    ``torch.profiler`` with device activity only, read from the trace's
    raw events: at ~10^5 events a training step's ``key_averages()``
    takes ~30 s, the raw events ~1.5 s. The events are kernels, copies
    and memsets. An error of ``fn`` propagates as it is; one of the
    profiler is raised as ``TraceError``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    in_fn = False
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            in_fn = True
            result = fn()
            torch.cuda.synchronize()
            in_fn = False
        evs = [(e.name(), e.duration_ns() / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.duration_ns() > 0]
    except Exception as exc:
        if in_fn:
            raise
        raise TraceError(f"{type(exc).__name__}: {exc}") from exc
    return evs, result


def profile_device(fn):
    """(profile, fn()) for one call (``device_trace``): the device
    kernels' busy ms, their launches, K9's ms and the top 8 kernels;
    "not measured" if the trace has no device times."""
    evs, result = device_trace(fn)
    if not evs:
        return {"not_measured": "no device times in the trace"}, result
    by_name: dict = {}
    for name, us in evs:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    busy = sum(us for _, us in evs) / 1e3
    k9 = sum(v[0] for n, v in by_name.items()
             if "moe_group_matmul" in n) / 1e3
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:8]
    return {"device_busy_ms": busy, "k9_ms": k9,
            "k9_share_of_busy": k9 / busy, "kernel_launches": len(evs),
            "top": [{"kernel": n[:80], "ms": v[0] / 1e3, "count": v[1]}
                    for n, v in top]}, result


def print_profile(label: str, o: dict, wall_ms: float) -> dict:
    """Adds the unprofiled wall time and the idle share to a
    ``profile_device`` result, prints it and returns it."""
    if "not_measured" in o:
        print(f"[chip_smoke]   profile {label}: not measured "
              f"({o['not_measured']})", flush=True)
        return o
    o["wall_ms"] = wall_ms
    o["idle_share"] = max(0.0, 1 - o["device_busy_ms"] / wall_ms)
    print(f"[chip_smoke]   profile {label}: wall {wall_ms:.2f} ms "
          f"unprofiled, device kernels {o['device_busy_ms']:.2f} ms (idle "
          f"{o['idle_share']:.3f}), K9 {o['k9_ms']:.2f} ms "
          f"({o['k9_share_of_busy']:.3f} of busy), {o['kernel_launches']} "
          f"kernel launches", flush=True)
    for t in o["top"]:
        print(f"[chip_smoke]     {t['ms']:9.3f} ms x{t['count']:<5} "
              f"{t['kernel']}", flush=True)
    return o


def profile_lm(res, steps: int = 3) -> dict:
    """Device time by kernel over one prefill and ``steps`` decode steps
    of the served model (``profile_device``), K9's share of it, and the
    device's idle share of the same work timed without the profiler
    (synchronized host clock)."""
    import torch
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

    out = {}
    for name, fn in (("prefill", run_prefill), ("decode", run_decode)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        try:
            o, _ = profile_device(fn)
        except TraceError as exc:   # instrumentation only: report, go on
            o = {"not_measured": str(exc)}
        o["steps"] = 1 if name == "prefill" else steps
        out[name] = print_profile(f"{name} x{o['steps']}", o, wall_ms)
    return out


# phase 11: the tenants of ``serve --mode fleet`` (t0 and t2 road_like,
# t1 hhh_like at the same scale; t2 is a plan-cache hit on t0's matrix)
FLEET_ARGS = ["--mode", "fleet", "--matrix", "road_like", "--tenants",
              "3", "--max-batch", str(MAIN_K), "--requests", "192"]


def fleet_summary(label: str, res, doc, counts) -> dict:
    """One fleet run's per-tenant flush latency (ms; pre-/post-loss when a
    position was lost), re-deal ms, launches, the plan cache's hits and
    misses and the run's seconds."""
    hists = {(h["name"], h["labels"].get("tenant")): h
             for h in doc["histograms"] if h["count"]}
    fleet, front = res["fleet"], res["front"]
    tenants = {}
    for t in front.tenants():
        row = {"matrix_rows": fleet.get(t).shape[0],
               "plan": fleet.get(t).plan.label,
               "flushes": front.lane(t).flushes,
               "slo_violations": front.lane(t).slo_violations,
               "launches": {ph: c for (tt, ph), c in
                            res["launches"].items() if tt == t}}
        for name in ("fleet/flush_s", "fleet/flush_preloss_s",
                     "fleet/flush_postloss_s", "fleet/redeal_s"):
            h = hists.get((name, t))
            if h is not None:
                row[name[6:]] = {q: h[q] * 1e3 for q in ("p50", "p95",
                                                          "p99")}
        tenants[t] = row
    out = {"run": label, "tenants": tenants,
           "plan_cache_hits": fleet.stats.plan_cache_hits,
           "plan_cache_misses": fleet.stats.plan_cache_misses,
           "redeal_ms": (None if res["redeal_s"] is None
                         else res["redeal_s"] * 1e3),
           "seconds": res["seconds"], "launches": counts}
    print(f"[chip_smoke] fleet {label}: {json.dumps(out)}", flush=True)
    return out


def run_fleet(scale: str) -> list:
    """Phase 11: ``serve --mode fleet`` through the entry point, the
    counts set to 0 just before each run and read just after: (a) one
    card (K1); (b) four positions of cuda:0 with the fused compact-X
    gather (K8), the last position lost halfway through. The serve run
    checks every answer against its tenant's oracle itself."""
    import torch
    t_phase = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra, kern in (
                ("a", ["--devices", "1"], "K1"),
                ("b", ["--devices", str(MESH_P), "--mesh-devices",
                       ",".join(["cuda:0"] * MESH_P), "--compact-x", "on",
                       "--gather", "fused", "--fail-device", "auto"],
                 "K8")):
            path = os.path.join(tmp, f"fleet_{label}.json")
            res, counts, doc = run_serve(FLEET_ARGS + ["--scale", scale]
                                         + extra, path)
            row = fleet_summary(label, res, doc, counts)
            if counts[kern] <= 0:
                raise AssertionError(f"fleet run {label} never launched "
                                     f"{kern}: {counts}")
            if (row["plan_cache_hits"], row["plan_cache_misses"]) != (1, 2):
                raise AssertionError(f"fleet run {label}: plan cache "
                                     f"{row['plan_cache_hits']} hits, "
                                     f"{row['plan_cache_misses']} misses")
            if label == "b":
                for phase in ("preloss", "postloss"):
                    n = sum(c[kern] for (t, ph), c in
                            res["launches"].items() if ph == phase)
                    if n <= 0:
                        raise AssertionError(f"fleet run b launched no {kern}"
                                             f" {phase}")
                    row[f"{kern}_{phase}"] = n
            rows.append(row)
            del res
            torch.cuda.empty_cache()
    print(f"[chip_smoke] fleet phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows


TUNE_ALGOS = ("parcrs", "csb", "csbh", "bcohc", "bcohch", "mergeb",
              "sellcs")     # the reference's DEFAULT_ALGOS and sellcs


def tune_sweep(coo, name: str, algos, beta: int, k: int, reps: int) -> dict:
    """``autotune`` over ``algos`` at one k, one candidate per call with
    the counters set to 0 just before and read just after, and the
    break-even of the fastest multiply against parcrs."""
    from repro_torch.core import autotune
    results, rows = [], []
    for algo in algos:
        (_, res), counts = run_counted(lambda: autotune(
            coo, num_spmvs=1000, algorithms=(algo,), betas=[beta],
            reps=reps, k=k))
        r = res[0]
        results.append(r)
        kern = [n for n, c in counts.items() if c] or ["oracle"]
        rows.append({"algorithm": r.algorithm, "beta": r.beta,
                     "convert_s": r.convert_s, "spmv_s": r.spmv_s,
                     "total_s": r.total_s, "kernels": kern,
                     "launches": {n: c for n, c in counts.items() if c}})
        print(f"[chip_smoke] autotune {name} k={k} {r.algorithm:7s} beta "
              f"{r.beta} convert_s {r.convert_s:.6f} spmv_s "
              f"{r.spmv_s:.9f} total_s {r.total_s:.6f} kernels {kern}",
              flush=True)
    best = min(results, key=lambda r: r.total_s)
    fast = min(results, key=lambda r: r.spmv_s)
    base = next(r for r in results if r.algorithm == "parcrs")
    gain = base.spmv_s - fast.spmv_s
    # none: parcrs multiplies fastest; 0: the faster format also
    # converts faster, so it pays from the first multiply
    breakeven = (max((fast.convert_s - base.convert_s) / gain, 0.0)
                 if fast is not base and gain > 0 else None)
    verdict = ("none (parcrs is the fastest)" if breakeven is None
               else f"{breakeven} multiplies")
    print(f"[chip_smoke] autotune {name} k={k}: best at 1000 multiplies "
          f"{best.algorithm}; fastest multiply {fast.algorithm}; "
          f"break-even against parcrs {verdict}", flush=True)
    return {"rows": rows, "best": best.algorithm, "fastest": fast.algorithm,
            "breakeven_vs_parcrs": breakeven}


def run_autotune(scale: float, rmat_scale: int, reps: int) -> dict:
    """Phase 12: ``core.autotune`` on the card at road_like, k = 1 and
    k = 32, one candidate per call so that the counters name the kernel
    each launched (the grid is the same as one call over all of them),
    and the break-even of the num_spmvs -> inf winner against parcrs;
    the same for parcrs and sellcs at hhh_like; one
    ``autotune(num_devices=4, k=32)`` call over parcrs and sellcs; then
    PageRank (K2 and the carry step before its swap, K1 after)."""
    import torch
    from repro_torch.core import IN_BLOCK_PACKED_COO, autotune, block_size_for
    from repro_torch.data import matrices
    from repro_torch.examples import pagerank
    t_phase = time.perf_counter()
    coo = matrices.as_coo(matrices.test_suite(scale)["road_like"].make(),
                          device="cuda")
    beta = block_size_for(coo.shape, in_block_format=IN_BLOCK_PACKED_COO)
    out = {"matrix": "road_like", "scale": scale, "m": coo.shape[0],
           "nnz": coo.nnz, "beta": beta, "num_spmvs": 1000, "reps": reps}
    for k in (1, MAIN_K):
        out[f"k{k}"] = tune_sweep(coo, "road_like", TUNE_ALGOS, beta, k,
                                  reps)
    # a second matrix, the two unblocked candidates only: the break-even
    # where the converted format may win
    hhh = matrices.as_coo(matrices.test_suite(scale)["hhh_like"].make(),
                          device="cuda")
    out["hhh_like"] = {"m": hhh.shape[0], "nnz": hhh.nnz}
    for k in (1, MAIN_K):
        out["hhh_like"][f"k{k}"] = tune_sweep(hhh, "hhh_like",
                                              ("parcrs", "sellcs"), beta,
                                              k, reps)
    del hhh
    # a mesh plan executes only the SELL-C-σ stream, and the blocked
    # candidates' conversions are most of the phase: the unblocked two
    best4, _ = autotune(coo, num_spmvs=1000, algorithms=("parcrs", "sellcs"),
                        reps=reps, k=MAIN_K, num_devices=MESH_P)
    out["num_devices_4"] = {
        "algorithm": best4.algorithm, "schedule": best4.schedule,
        "num_chunks": best4.num_chunks, "mesh_shape": best4.mesh_shape,
        "compact_x": best4.compact_x, "gather": best4.gather,
        "dist_model_s": best4.dist_model_s, "total_s": best4.total_s}
    print(f"[chip_smoke] autotune num_devices={MESH_P} k={MAIN_K}: "
          f"{out['num_devices_4']}", flush=True)
    del coo
    torch.cuda.empty_cache()
    out["autotune_seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] autotune {out['autotune_seconds']:.1f} s",
          flush=True)
    # the operator multiplies a vector as a one-column SpMM, as the
    # reference's does: the merge-path leg runs K2 and the carry step
    res, counts = run_counted(lambda: pagerank.main(
        ["--device", "cuda", "--scale", str(rmat_scale)]))
    for kern in ("K2", "carry", "K1"):
        if counts[kern] <= 0:
            raise AssertionError(f"pagerank never launched {kern}")
    out["pagerank"] = {"scale": rmat_scale, "plans": res["plans"],
                       "convert_s": res["convert_s"],
                       "max_abs_diff": float((res["r1"] - res["r2"]).abs()
                                             .max()),
                       "launches": counts}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] pagerank rmat {rmat_scale}: plans {res['plans']}; "
          f"launches {counts}; autotune phase {out['seconds']:.1f} s",
          flush=True)
    return out


# phase 13: the Mamba-2 SSM mixer served and trained at full width
SSM_ARCH = "mamba2-1.3b"
SSM_BATCH, SSM_PROMPT, SSM_GEN = 8, 512, 16
SSM_NAIVE_ROWS, SSM_NAIVE_TOKENS = 2, 4
# float32 serving path vs the naive recurrence: on an H100, max|logit|
# 4.77, it reads 6.39e-05, and 0.0257 with the conv state rounded to bf16
SSM_TOL_REL = 1e-4
# the served bf16 run vs the naive recurrence in bf16: 0.195 and 0.212 in
# two H100 runs, max|logit| 4.74
SSM_BF16_TOL_REL = 1e-1
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_SAVE = 4, 512, 3, 2
TRAIN_LR = 1e-3          # train.py's default --lr
TRAIN_REL = 1e-3         # resumed losses vs the uninterrupted run
# the replayed steps' parameters vs the uninterrupted run's last ones,
# relative to the norm of the update the replay makes: a lost or mangled
# optimizer state (moments, step count) moves it by O(1)
TRAIN_UPDATE_REL = 1e-2
MIXER_K = 16             # the sparse-mixer phase's width (its d_out)


def scan_recurrence(p, scfg, u):
    """``ssm_forward_naive``'s function (``ssm_decode``'s recurrence, one
    token at a time from a zero state) with the position-wise parts (the
    projections, the causal conv over the whole sequence, the activations,
    the gated norm and the output projection) computed for all positions
    at once: ~6 launches a token in place of one ``ssm_decode``'s ~35."""
    import torch
    from repro_torch.models.layers import dense
    from repro_torch.models.ssm import _conv_act, _gated_norm
    B, S, _ = u.shape
    z, x, Bm, Cm, dt, _ = _conv_act(p, scfg, u)
    a = torch.exp(dt * -torch.exp(p["A_log"].to(torch.float32)))  # [B,S,H]
    dx = dt[..., None] * x                                      # [B,S,H,P]
    state = torch.zeros(x.shape[:1] + x.shape[2:] + (scfg.d_state,),
                        dtype=torch.float32, device=u.device)
    ys = torch.empty_like(x)
    for t in range(S):
        state = state * a[:, t, :, None, None] \
            + dx[:, t, :, :, None] * Bm[:, t, None, None, :]
        ys[:, t] = torch.einsum("bn,bhpn->bhp", Cm[:, t], state)
    y = ys + x * p["D"].to(torch.float32)[None, None, :, None]
    y = _gated_norm(p, y.reshape(B, S, scfg.d_inner), z)
    return dense(p["out_proj"], y.to(u.dtype))


def naive_lm_logits(params, cfg, tokens):
    """The SSM stack's logits at every position of ``tokens`` with every
    mixer run as the step-by-step recurrence (``scan_recurrence``), in
    the config's compute dtype."""
    import torch
    from repro_torch.models import model as M
    with torch.no_grad():
        h = M.embed_inputs(cfg, params, tokens)
        for l, lp in enumerate(params["layers"]):
            mixer, mlp = M.layer_kinds(cfg, l)
            if mixer != "ssm":
                raise ValueError("the naive check runs SSM stacks only")
            hn = M._norm(cfg, lp["norm1"], h)
            h = h + scan_recurrence(lp["mixer"], cfg.ssm_config(), hn)
            h, _ = M._mlp_block(cfg, lp, mlp, h)
        h = M._norm(cfg, params["final_norm"], h)
        return M.logits_from_hidden(params, cfg, h)


def ssm_serve_checks(res) -> dict:
    """Layer 0's chunked ``ssm_forward`` against ``ssm_forward_naive`` in
    float32 on the served prompts' first rows. Then, for
    ``SSM_NAIVE_ROWS`` rows of the served prompts: the serving path
    (``prefill`` and ``SSM_NAIVE_TOKENS - 1`` greedy ``decode_step``s) in
    float32 compute against the naive recurrence through the whole stack
    in float32, teacher-forced on its tokens, held to ``SSM_TOL_REL``;
    beside it, the same decode steps from caches whose conv state was
    rounded to bf16 after prefill (the fault the check must see),
    reported. Last, the served run itself (the config's bf16 compute, the
    path that is timed): its prefill and decode logits against the naive
    recurrence in bf16, teacher-forced on the served tokens, held to
    ``SSM_BF16_TOL_REL``: bf16 rounds each layer's activations, and a
    product summed in another order rounds to the neighbouring bf16 value
    now and then, so the two bf16 paths drift apart with depth."""
    import dataclasses

    import torch
    from repro_torch.models import model as M
    from repro_torch.models.ssm import ssm_forward, ssm_forward_naive

    params, cfg = res["params"], res["cfg"]
    rows = res["prompts"][:SSM_NAIVE_ROWS]
    P, n = rows.shape[1], SSM_NAIVE_TOKENS
    out = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        lp = params["layers"][0]
        u = M._norm(cfg, lp["norm1"], params["embed"][rows].float())
        chunked = ssm_forward(lp["mixer"], cfg.ssm_config(), u)
        naive = ssm_forward_naive(lp["mixer"], cfg.ssm_config(), u)
    err = max_err(chunked, naive)
    tol = TOL_REL * max(1.0, float(naive.abs().max()))
    out["layer0_f32"] = {"max_abs_err": err, "tol": tol}
    print(f"[chip_smoke]   mamba2 layer 0 chunked ssm_forward vs "
          f"ssm_forward_naive (float32, {SSM_NAIVE_ROWS} x {P} tokens): "
          f"max_abs_err {err:.3g} (tol {tol:.3g})", flush=True)
    if not err <= tol:
        raise AssertionError(f"chunked vs naive SSM: {err:.3g} > {tol:.3g}")

    def decode(cfg_, caches, lg, feed=None):
        """Logits [rows, n, vocab] of prefill's ``lg`` and n - 1 decode
        steps, each fed its own argmax or ``feed[:, i]``."""
        logits, toks = [lg], [lg.argmax(-1)]
        for i in range(n - 1):
            pos = torch.full((SSM_NAIVE_ROWS,), P + i, dtype=torch.int32,
                             device=rows.device)
            tok = toks[-1] if feed is None else feed[:, i]
            lg, caches = M.decode_step(params, cfg_, tok[:, None].to(
                torch.int32), caches, pos)
            logits.append(lg)
            toks.append(lg.argmax(-1))
        return torch.stack(logits, 1), torch.stack(toks, 1)

    # the serving path in float32 on these rows, and the same from caches
    # with the conv state rounded to bf16
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    lg, caches = M.prefill(params, f32, rows, P + n,
                           cache_dtype=torch.float32)
    rounded = [type(c)(c.conv_state.to(torch.bfloat16).float(),
                       c.ssm_state.clone()) for c in caches]
    served, toks = decode(f32, caches, lg)
    faulty, _ = decode(f32, rounded, lg, feed=toks)
    naive = naive_lm_logits(params, f32, torch.cat(
        [rows, toks[:, :-1].to(rows.dtype)], dim=1))[:, P - 1:]
    err, fault = max_err(served, naive), max_err(faulty, naive)
    tol = SSM_TOL_REL * max(1.0, float(naive.abs().max()))
    top2 = naive.topk(2, dim=-1).values
    differ = naive.argmax(-1) != toks
    # a token may differ only at a near-tie of the naive top two
    bad = differ & (top2[..., 0] - top2[..., 1] > tol)
    out["model_f32"] = {"max_abs_err": err, "tol": tol,
                        "max_abs": float(naive.abs().max()),
                        "conv_state_bf16_max_abs_err": fault,
                        "tokens_equal": int((~differ).sum()),
                        "tokens_checked": int(differ.numel())}
    print(f"[chip_smoke]   mamba2 prefill + {n - 1} decode steps vs the "
          f"naive recurrence ({cfg.n_layers} layers, float32 compute, rows"
          f" 0-{SSM_NAIVE_ROWS - 1}, {n} positions): logits max_abs_err "
          f"{err:.3g} (tol {tol:.3g}; the conv state rounded to bf16 after "
          f"prefill: {fault:.3g}); tokens equal "
          f"{out['model_f32']['tokens_equal']}/{differ.numel()}", flush=True)
    if not err <= tol or bool(bad.any()):
        raise AssertionError(f"mamba2 float32 serve vs naive: logits "
                             f"{err:.3g} (tol {tol:.3g}), tokens "
                             f"{toks.tolist()} vs "
                             f"{naive.argmax(-1).tolist()}")
    if not fault > tol:
        raise AssertionError(f"the float32 check cannot see a conv state "
                             f"rounded to bf16: {fault:.3g} <= {tol:.3g}")
    f32_prefill = served[:, 0]
    del caches, rounded, served, faulty, naive

    # the served run (bf16 compute) against the naive recurrence in bf16
    gen = torch.from_numpy(res["tokens"][:SSM_NAIVE_ROWS, :n]).to(
        rows.device)
    served = torch.cat([res["prefill_logits"][:SSM_NAIVE_ROWS, None],
                        res["decode_logits"][:SSM_NAIVE_ROWS, :n - 1]], 1)
    naive = naive_lm_logits(params, cfg, torch.cat(
        [rows, gen[:, :-1].to(rows.dtype)], dim=1))[:, P - 1:]
    err = max_err(served, naive)
    tol = SSM_BF16_TOL_REL * max(1.0, float(naive.abs().max()))
    top2 = naive.topk(2, dim=-1).values
    differ = naive.argmax(-1) != gen
    bad = differ & (top2[..., 0] - top2[..., 1] > tol)
    out["model_bf16"] = {
        "max_abs_err": err, "tol": tol, "max_abs": float(naive.abs().max()),
        "tokens_equal": int((~differ).sum()),
        "tokens_checked": int(differ.numel()),
        "prefill_vs_f32_max_abs_err": max_err(served[:, 0], f32_prefill),
        "first_tokens_equal_f32": int((gen == toks).sum()),
        "checks_s": time.perf_counter() - t0}
    o = out["model_bf16"]
    print(f"[chip_smoke]   mamba2 served run (bf16 compute, batch "
          f"{res['prompts'].shape[0]}) vs the naive recurrence in bf16 (rows "
          f"0-{SSM_NAIVE_ROWS - 1}, {n} positions): logits max_abs_err "
          f"{err:.3g} (tol {tol:.3g}); tokens equal {o['tokens_equal']}/"
          f"{differ.numel()}; against the float32 path: prefill logits "
          f"{o['prefill_vs_f32_max_abs_err']:.3g}, first {n} tokens equal "
          f"{o['first_tokens_equal_f32']}/{gen.numel()}; checks "
          f"{o['checks_s']:.1f} s", flush=True)
    if not err <= tol or bool(bad.any()):
        raise AssertionError(f"mamba2 bf16 serve vs naive: logits "
                             f"{err:.3g} (tol {tol:.3g}), tokens "
                             f"{gen.tolist()} vs {naive.argmax(-1).tolist()}")
    return out


def run_ssm_train(quick: bool) -> dict:
    """Phase 13: serve mamba2-1.3b at full width and check it against the
    naive recurrence, serve jamba reduced through K9 and its plain
    version, train mamba2-1.3b at full width with checkpoints and resume
    from the first in a fresh ``Supervisor`` (the steps after it re-run
    with the same step function, the first of them profiled, and the
    parameters after them held against the first run's last), and run
    the ``train_lm`` example's sparse-mixer phase."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.examples import train_lm
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import Supervisor

    t_phase = time.perf_counter()
    precision = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                 "float32_matmul_precision":
                     torch.get_float32_matmul_precision()}
    print(f"[chip_smoke] phase 13: float32 matmuls and einsums (the SSM "
          f"scan, loss_fn's logits) at {precision}", flush=True)
    out = {"precision": precision, "marks_s": {}}

    def mark(label):
        out["marks_s"][label] = time.perf_counter() - t_phase
        print(f"[chip_smoke]   +{out['marks_s'][label]:.1f} s: {label}",
              flush=True)

    # 13.1 serve mamba2-1.3b at full width
    batch, prompt, gen_len = ((2, 64, 4) if quick else
                              (SSM_BATCH, SSM_PROMPT, SSM_GEN))
    argv = ["--mode", "lm", "--arch", SSM_ARCH, "--batch", str(batch),
            "--prompt-len", str(prompt), "--gen", str(gen_len), "--seed",
            "0"] + (["--n-layers", "4"] if quick else [])
    torch.cuda.reset_peak_memory_stats()
    res, counts = run_counted(lambda: serve.main(argv))
    cfg = res["cfg"]
    tok, logits = res["tokens"], res["prefill_logits"]
    if tok.shape != (batch, gen_len) or not bool(
            ((tok >= 0) & (tok < cfg.vocab)).all()) or not bool(
                torch.isfinite(logits).all()):
        raise AssertionError("serve --mode lm mamba2: malformed output")
    serve_row = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_params": res["n_params"], "batch": batch, "prompt": prompt,
        "gen": gen_len, "prefill_ms": res["t_prefill"] * 1e3,
        "decode_ms_per_step": res["t_decode"] * 1e3 / (gen_len - 1),
        "tok_per_s": res["tok_per_s"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": {k: v for k, v in counts.items() if v}}
    print(f"[chip_smoke] serve --mode lm --arch {SSM_ARCH} ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {res['n_params']} params): "
          f"prefill {serve_row['prefill_ms']:.1f} ms, decode "
          f"{serve_row['decode_ms_per_step']:.2f} ms/step, "
          f"{serve_row['tok_per_s']:.1f} tok/s, peak "
          f"{serve_row['peak_gib']:.2f} GiB; kernel launches "
          f"{serve_row['launches'] or 'none (plain torch)'}", flush=True)
    mark("mamba2 served")
    serve_row["checks"] = ssm_serve_checks(res)
    mark("checks")
    serve_row["profile"] = profile_lm(res, steps=1)
    mark("profile")
    out["serve"] = serve_row
    del res, logits
    torch.cuda.empty_cache()

    # 13.2 the jamba hybrid, reduced: K9 against its plain version
    jargv = ["--mode", "lm", "--arch", "jamba-1.5-large-398b", "--reduced",
             "--batch", "4", "--prompt-len", "32", "--gen", "8", "--seed",
             "0"]
    runs = {}
    for impl in ("kernel", "plain"):
        r, c = run_counted(lambda: serve.main(jargv + ["--impl", impl]))
        runs[impl] = (r, c)
    (rk, ck), (rp, cp) = runs["kernel"], runs["plain"]
    # the prefill's and every decode step's logits; each run feeds its own
    # tokens, so a step is compared where the tokens fed so far agree, and
    # a token may differ only at a near-tie of the plain run's top two
    lk, lp = (torch.cat([r["prefill_logits"][:, None], r["decode_logits"]],
                        1) for r in (rk, rp))
    tk, tp = (torch.from_numpy(r["tokens"]).to(lk.device) for r in (rk, rp))
    agree = torch.cumprod((tk == tp).int(), 1).bool()
    fed = torch.cat([torch.ones_like(agree[:, :1]), agree[:, :-1]], 1)
    err = float((lk - lp).abs().amax(-1)[fed].max())
    tol = LAYER_TOL_REL * max(1.0, float(lp.abs().max()))
    top2 = lp.topk(2, dim=-1).values
    bad = fed & (tk != tp) & (top2[..., 0] - top2[..., 1] > tol)
    k9 = {k: ck[k] for k in ("K9", "K9d", "K9w")}
    out["jamba"] = {"max_abs_err": err, "tol": tol,
                    "steps_compared": int(fed.sum()),
                    "steps": int(fed.numel()),
                    "tokens_equal": bool(torch.equal(tk, tp)),
                    "launches_kernel": k9,
                    "launches_plain": {k: cp[k] for k in k9}}
    print(f"[chip_smoke] serve jamba reduced --impl kernel vs plain: prefill"
          f" and decode logits max_abs_err {err:.3g} (tol {tol:.3g}) over "
          f"{out['jamba']['steps_compared']}/{out['jamba']['steps']} row "
          f"steps; tokens equal {out['jamba']['tokens_equal']}; K9 launches "
          f"{k9} (plain {out['jamba']['launches_plain']})", flush=True)
    if not err <= tol or bool(bad.any()):
        raise AssertionError(f"jamba kernel vs plain: {err:.3g} (tol "
                             f"{tol:.3g}), tokens {tk.tolist()} vs "
                             f"{tp.tolist()}")
    if ck["K9"] <= 0 or ck["K9d"] <= 0 or any(out["jamba"]["launches_plain"]
                                               .values()):
        raise AssertionError(f"jamba serve: K9 launches {k9}, plain "
                             f"{out['jamba']['launches_plain']}")
    del runs, rk, rp
    torch.cuda.empty_cache()
    mark("jamba")

    # 13.3 train mamba2-1.3b at full width, save, resume in a fresh
    # Supervisor from step TRAIN_SAVE and re-run the steps after it
    tb, ts = (2, 64) if quick else (TRAIN_BATCH, TRAIN_SEQ)
    targv = ["--arch", SSM_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
             str(tb), "--seq", str(ts), "--optimizer", "adamw",
             "--save-every", str(TRAIN_SAVE), "--seed", "0",
             "--lr", str(TRAIN_LR)] + (["--reduced"] if quick else [])
    with tempfile.TemporaryDirectory() as ck:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r1 = train.main(targv + ["--ckpt-dir", ck])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tcfg = r1["cfg"]
        losses1, step_s = r1["losses"], r1["step_s"]
        n_params = tcfg.param_count(r1["state"].params)
        final = leaves(r1["state"].params)   # after the last update
        del r1
        torch.cuda.empty_cache()
        mark("trained")

        opt = make_optimizer("adamw", warmup_cosine(
            TRAIN_LR, max(TRAIN_STEPS // 10, 1), TRAIN_STEPS))
        params = init_params(torch.Generator(device="cuda").manual_seed(1),
                             tcfg)
        state = TrainState(params, opt.init(params))
        del params
        # the last commit is taken back, as if the run had died before
        # it: a fresh Supervisor resumes from the one before
        os.remove(os.path.join(ck, f"step_{TRAIN_STEPS:08d}.COMMITTED"))
        t0 = time.perf_counter()
        state, start = Supervisor(ck).restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        # the replay's update, as the first run made it
        with torch.no_grad():
            upd_sq = sum((f - t).double().square().sum()
                         for f, t in zip(final, leaves(state.params)))
        mark("restored")
    pipe = TokenPipeline(vocab=tcfg.vocab, batch=tb, seq=ts, seed=0)
    step_fn = make_train_step(tcfg, opt)
    losses2, replay_s, profile = [], [], None
    for step in range(start, TRAIN_STEPS):
        batch = {"tokens": torch.from_numpy(
            pipe.batch_at(step)["tokens"]).cuda()}
        t0 = time.perf_counter()
        if profile is None:
            profile, (state, m) = profile_device(
                lambda: step_fn(state, batch))
        else:
            state, m = step_fn(state, batch)
        losses2.append(float(m["loss"]))
        replay_s.append(time.perf_counter() - t0)
    # the loss of the last replayed step is read before its update: the
    # parameters after it hold the restored moments and step count too
    with torch.no_grad():
        err_sq = sum((t - f).double().square().sum()
                     for t, f in zip(leaves(state.params), final))
    update_rel = float((err_sq / upd_sq).sqrt())
    del state, final
    torch.cuda.empty_cache()
    mark("replayed")
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(losses2, losses1[start:])]
    tokens = tb * ts
    steady = step_s[1:] or step_s
    out["train"] = {
        "arch": tcfg.name, "layers": tcfg.n_layers, "n_params": n_params,
        "batch": tb, "seq": ts, "losses": losses1,
        "resumed_losses": losses2, "resume_rel_err": rel,
        "resume_update_rel_err": update_rel,
        "step_ms": [s * 1e3 for s in step_s],
        "tok_per_s": tokens / (sum(steady) / len(steady)),
        "peak_gib": peak, "run_s": train_s, "restore_s": restore_s,
        "profile_step": profile}
    print(f"[chip_smoke] train {SSM_ARCH} ({tcfg.n_layers} layers, "
          f"{n_params} params, batch {tb} x seq {ts}, AdamW, remat): losses "
          f"{[round(x, 5) for x in losses1]}; step ms "
          f"{[round(s * 1e3, 1) for s in step_s]} ("
          f"{out['train']['tok_per_s']:.0f} tok/s after the first); peak "
          f"{peak:.2f} GiB; run {train_s:.1f} s with 2 checkpoints; "
          f"restore {restore_s:.1f} s; resumed from step {start}: "
          f"{[round(x, 5) for x in losses2]}, rel err "
          f"{[f'{x:.2g}' for x in rel]}; parameters after the replay vs "
          f"the first run's, relative to the update: {update_rel:.3g} (tol "
          f"{TRAIN_UPDATE_REL})", flush=True)
    # the idle share against the same step's unprofiled wall time in the
    # first run
    print_profile(f"train step {start}", profile, step_s[start] * 1e3)
    if start != TRAIN_SAVE or len(losses2) != TRAIN_STEPS - TRAIN_SAVE or not all(
            np.isfinite(losses1)) or max(rel) > TRAIN_REL:
        raise AssertionError(f"resumed losses {losses2} vs {losses1}")
    if not update_rel <= TRAIN_UPDATE_REL:
        raise AssertionError(f"the replayed update is {update_rel:.3g} off "
                             f"the first run's (tol {TRAIN_UPDATE_REL})")

    # 13.4 the train_lm example's sparse-mixer phase, then its kernels
    # against their plain versions at its shapes (these launches are not
    # counted) and the same phase through the plain versions
    from repro_torch.spmm import spmm
    from repro_torch.spmm.sellcs import SellCS
    mix, counts = run_counted(lambda: train_lm.sparse_mixer_phase("cuda"))
    moved = {k: v for k, v in counts.items() if v}
    op = mix["op"]
    mat = op.plan.matrix
    X = torch.randn((op.shape[1], MIXER_K), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    pairs = [("forward", op.plan.multiply(X), spmm(mat, X, impl="plain"))]
    if isinstance(mat, SellCS):
        pairs.append(("transpose", op.plan.multiply_t(X),
                      spmm(mat, X, impl="plain", op="T")))
    checks = {label: {"max_abs_err": max_err(y, ref),
                      "tol": tol_of(ref)} for label, y, ref in pairs}
    plain = train_lm.sparse_mixer_phase("cuda", impl="plain")
    loss_err = max(abs(a - b) for a, b in zip(mix["losses"],
                                              plain["losses"]))
    loss_tol = TOL_REL * max(1.0, abs(plain["loss0"]))
    out["sparse_mixer"] = {"loss0": mix["loss0"], "loss": mix["loss"],
                           "plan": mix["plan"], "launches": moved,
                           "multiplies": mix["stats"].multiplies,
                           "kernel_vs_plain": checks,
                           "loss_vs_plain_max_abs_err": loss_err,
                           "loss_tol": loss_tol}
    print(f"[chip_smoke] train_lm sparse-mixer phase: plan {mix['plan']}, "
          f"loss {mix['loss0']:.4f} -> {mix['loss']:.4g}, "
          f"{mix['stats'].multiplies} multiplies; launches {moved}; at k = "
          f"{MIXER_K} against the plain versions: "
          + ", ".join(f"{k} {v['max_abs_err']:.3g} (tol {v['tol']:.3g})"
                      for k, v in checks.items())
          + f"; each step's loss against the plain run's: max_abs_err "
          f"{loss_err:.3g} (tol {loss_tol:.3g})", flush=True)
    if not mix["loss"] < 0.1 * mix["loss0"]:
        raise AssertionError("sparse-mixer phase failed to learn")
    if mix["plan"].startswith("sellcs") and not (counts["K1"] > 0
                                                 and counts["K3"] > 0):
        raise AssertionError(f"sparse-mixer phase: K1/K3 never launched "
                             f"({moved})")
    if not moved:
        raise AssertionError("sparse-mixer phase launched no kernel")
    if not (all(v["max_abs_err"] <= v["tol"] for v in checks.values())
            and len(plain["losses"]) == len(mix["losses"])
            and loss_err <= loss_tol):
        raise AssertionError(f"sparse-mixer kernels vs plain: {checks}, "
                             f"losses {loss_err:.3g} > {loss_tol:.3g}")

    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] ssm/train phase {out['seconds']:.1f} s", flush=True)
    return out


# phase 14: the LM mesh on four positions of cuda:0
EP_MESH = (1, 4)          # (data, model): the experts split four ways
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 4, 512, 3
MESH_TRAIN_REL = 1e-3     # mesh losses vs one device's (bf16 compute)
# at train.py's default --lr 1e-3 (one warm-up step) granite diverges from
# random init (11.74 -> 9.63 -> 11.27) and two 1x1 runs on an H100 differ
# by up to 3.4e-3 at the third step (atomic adds in the backward pass,
# amplified); at 1e-4 the loss descends (-> 9.82 -> 9.06) and 1x1 repeats
# itself to the bit, so the mesh is held against it there
MESH_TRAIN_LR = 1e-4


def run_lm_mesh(quick: bool, reps: int) -> dict:
    """Phase 14: (a) one granite-moe-1b-a400m MoE layer at the served
    prefill shapes (batch 32 x 128 tokens, bf16 rows, random weights from
    seed 0) through ``moe_apply_ep`` on a (1, 4) mesh of four positions of
    cuda:0 (local products through K9's tensor-core kernel): without
    drops (capacity factor 4) against the baseline ``moe_apply`` (K9), at
    the default 1.3 against the same dispatch through K9's plain version
    (with its dropped slots), and ``moe_apply_ep_tp`` (d_ff 512 -> 128 a
    position) against the baseline, each within ``LAYER_TOL_REL * max(1,
    max|other|)``; their K9 launches are counted around the three
    dispatches, and each is timed beside the baseline. (b) ``train
    --mesh 2x2`` on four positions of cuda:0 against ``--mesh 1x1``: 3
    AdamW steps of granite-moe-1b-a400m at full width and depth (batch 4
    x seq 512, cut from train_4k's 4,096), losses within
    ``MESH_TRAIN_REL`` at ``MESH_TRAIN_LR``; ms a step, tokens/s, the
    peak memory beside its reckoning and one more step's device events
    (``device_trace``) for both. No checkpoint is written."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import moe as M
    from repro_torch.optim import make_optimizer, warmup_cosine

    t_phase = time.perf_counter()
    out = {}
    d, f, E, top = (GRANITE[k] for k in ("d", "f", "E", "top"))
    B, S = (4, 128) if quick else (LM_BATCH, LM_PROMPT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = M.MoEConfig(d, f, E, top, use_kernel=True)
    p = M.moe_init(gen, cfg, torch.float32)
    x = torch.randn((B, S, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    mesh = make_mesh(EP_MESH, ("data", "model"), devices=["cuda:0"] * 4)
    n_ep = EP_MESH[1]

    def ep(cf, c=cfg):
        with set_mesh(mesh):
            return M.moe_apply_ep(p, c, x, capacity_factor=cf)

    def dropped_at(cf):
        with set_mesh(mesh):
            return M.ep_dropped_slots(p, cfg, x, capacity_factor=cf)

    def ep_tp():
        with set_mesh(mesh):
            return M.moe_apply_ep_tp(p, cfg, x)

    # (a) the three dispatches, counted
    torch.cuda.synchronize()
    reset_counts()
    y_full, aux_full = ep(float(n_ep))
    y_ep, aux_ep = ep(1.3)
    y_tp, aux_tp = ep_tp()
    torch.cuda.synchronize()
    counts = read_counts()
    want_k9w = 3 * 3 * n_ep          # 3 dispatches x 4 positions x 3
    if counts["K9w"] != want_k9w or counts["K9"] or counts["K9d"]:
        raise AssertionError(f"the EP dispatches launched {counts}, not "
                             f"{want_k9w} tensor-core K9 launches")
    # the comparisons, uncounted
    base, aux_base = M.moe_apply(p, cfg, x)
    y_plain, aux_plain = ep(1.3, cfg._replace(plain=True))
    drop_full, dropped = dropped_at(float(n_ep)), dropped_at(1.3)
    checks = {}
    for label, got, other in (("ep_nodrop_vs_baseline", y_full, base),
                              ("ep_1.3_vs_plain", y_ep, y_plain),
                              ("ep_tp_vs_baseline", y_tp, base)):
        err = max_err(got, other)
        tol = LAYER_TOL_REL * max(1.0, float(other.float().abs().max()))
        checks[label] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"phase 14 {label}: {err:.3g} > {tol:.3g}")
    if drop_full != 0:
        raise AssertionError(f"{drop_full} slots dropped at capacity "
                             f"{n_ep}")
    ms = {"baseline": cuda_ms(lambda: M.moe_apply(p, cfg, x), reps),
          "ep_nodrop": cuda_ms(lambda: ep(float(n_ep)), reps),
          "ep_1.3": cuda_ms(lambda: ep(1.3), reps),
          "ep_tp": cuda_ms(ep_tp, reps)}
    out["ep"] = {"tokens": B * S, "slots": B * S * top, "mesh": EP_MESH,
                 "dropped_slots_at_1.3": dropped, "checks": checks,
                 "aux": {"baseline": float(aux_base), "ep_nodrop":
                         float(aux_full), "ep_1.3": float(aux_ep),
                         "ep_tp": float(aux_tp)},
                 "ms": ms, "launches": {k: v for k, v in counts.items()
                                        if v}}
    print(f"[chip_smoke] phase 14 (a) granite MoE layer, {B} x {S} bf16 "
          f"tokens on a {EP_MESH} mesh of cuda:0: EP without drops vs "
          f"moe_apply {checks['ep_nodrop_vs_baseline']['max_abs_err']:.3g},"
          f" EP at 1.3 ({dropped} of {B * S * top} slots dropped) vs its "
          f"plain version {checks['ep_1.3_vs_plain']['max_abs_err']:.3g}, "
          f"EP-TP vs moe_apply "
          f"{checks['ep_tp_vs_baseline']['max_abs_err']:.3g} (tol "
          f"{checks['ep_tp_vs_baseline']['tol']:.3g}); ms: "
          f"{ {k: round(v, 3) for k, v in ms.items()} }; K9 launches "
          f"{out['ep']['launches']}", flush=True)
    del p, x, base, y_full, y_ep, y_tp, y_plain
    torch.cuda.empty_cache()

    # (b) train --mesh 2x2 against --mesh 1x1
    argv = ["--arch", "granite-moe-1b-a400m", "--steps",
            str(MESH_TRAIN_STEPS), "--batch", str(MESH_TRAIN_BATCH),
            "--seq", str(MESH_TRAIN_SEQ), "--optimizer", "adamw",
            "--lr", str(MESH_TRAIN_LR), "--save-every", "0", "--seed",
            "0"] + (
                ["--reduced"] if quick else [])
    runs = {}
    for label, extra in (("1x1", []),
                         ("2x2", ["--mesh", "2x2", "--mesh-devices",
                                  ",".join(["cuda:0"] * 4)])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = train.main(argv + extra)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tcfg = r["cfg"]
        params = r["state"].params
        n_params = sum(t.numel() for t in params.parameters()) \
            if label == "1x1" else sum(
                int(np.prod(st.shape)) for st in params.parameters())
        # the reckoning: f32 parameters placed once, AdamW's two moments,
        # and a gathered copy with its gradients per data block (one
        # device: the gradients alone)
        copies = 3 + (4 if label == "2x2" else 1)
        reckoned = n_params * 4 * copies / 2 ** 30
        # one more step, profiled: its kernel launches
        opt = make_optimizer("adamw", warmup_cosine(
            MESH_TRAIN_LR, max(MESH_TRAIN_STEPS // 10, 1),
            MESH_TRAIN_STEPS))
        step_fn = make_train_step(
            tcfg, opt, mesh=None if label == "1x1" else make_mesh(
                (2, 2), ("data", "model"), devices=["cuda:0"] * 4))
        pipe = TokenPipeline(vocab=tcfg.vocab, batch=MESH_TRAIN_BATCH,
                             seq=MESH_TRAIN_SEQ, seed=0)
        batch = {"tokens": torch.from_numpy(pipe.batch_at(
            MESH_TRAIN_STEPS)["tokens"]).cuda()}
        try:
            evs, _ = device_trace(lambda: step_fn(r["state"], batch))
            prof = {"device_events": len(evs),
                    "device_busy_ms": sum(us for _, us in evs) / 1e3}
        except TraceError as exc:   # instrumentation only: report, go on
            prof = {"not_measured": str(exc)}
        steady = r["step_s"][1:] or r["step_s"]
        runs[label] = {
            "losses": r["losses"], "step_ms": [t * 1e3 for t in r["step_s"]],
            "tok_per_s": MESH_TRAIN_BATCH * MESH_TRAIN_SEQ
            / (sum(steady) / len(steady)),
            "peak_gib": peak, "reckoned_gib": reckoned, "run_s": run_s,
            "n_params": n_params,
            "launches_per_step": prof.get("device_events"),
            "device_busy_ms": prof.get("device_busy_ms"),
            "profile": prof.get("not_measured", "ok")}
        del r, params, step_fn
        torch.cuda.empty_cache()
        o = runs[label]
        print(f"[chip_smoke] phase 14 (b) train --mesh {label} "
              f"({tcfg.n_layers} layers, {n_params} params, batch "
              f"{MESH_TRAIN_BATCH} x seq {MESH_TRAIN_SEQ}, AdamW): losses "
              f"{[round(v, 5) for v in o['losses']]}; step ms "
              f"{[round(v, 1) for v in o['step_ms']]} ({o['tok_per_s']:.0f} "
              f"tok/s after the first); peak {peak:.2f} GiB (reckoned "
              f"{reckoned:.2f} GiB before activations); one more step: "
              f"{o['launches_per_step']} device events (kernels, copies, "
              f"memsets), device busy {o['device_busy_ms']} ms; run "
              f"{run_s:.1f} s", flush=True)
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(runs["2x2"]["losses"], runs["1x1"]["losses"])]
    out["train"] = {**runs, "rel_err": rel,
                    "cut": f"seq {MESH_TRAIN_SEQ} of train_4k's 4096, "
                           f"batch {MESH_TRAIN_BATCH} of 256, "
                           f"{MESH_TRAIN_STEPS} steps"}
    print(f"[chip_smoke] phase 14 (b) mesh 2x2 vs 1x1 losses rel err "
          f"{[f'{v:.2g}' for v in rel]} (tol {MESH_TRAIN_REL})", flush=True)
    if len(rel) != MESH_TRAIN_STEPS or not all(
            np.isfinite(runs["2x2"]["losses"])) or max(rel) > MESH_TRAIN_REL:
        raise AssertionError(f"train --mesh 2x2 losses "
                             f"{runs['2x2']['losses']} vs 1x1 "
                             f"{runs['1x1']['losses']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] lm mesh phase {out['seconds']:.1f} s", flush=True)
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

    # library yardsticks in full f32 ("highest": no TF32 rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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
    for label, lib, name in (("K6/K7", "tiled", "tiled_spmm_kernel"),
                             ("K5", "tiled", "tiled_spmv_kernel"),
                             ("K4", "merge", "merge_spmv_kernel"),
                             ("K2", "merge", "merge_partials_kernel"),
                             ("K3", "sellcs", "sellcs_slots_t_kernel"),
                             ("K9", "moe", "moe_group_matmul_kernel"),
                             ("K9 decode", "moe", "decode_kernel"),
                             ("K9 wgmma", "moe", "wgmma_kernel")):
        report = ptxas_lines(_lib.BUILD_LOGS.get(lib, ""), name)
        for line in report or ["the library was built before this run: "
                               "no report"]:
            print(f"[chip_smoke] {label} ptxas: {line}", flush=True)

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
        # every merge multiply of serve B is one fused C entry call
        if (counts_b["merge_spmv_calls"], counts_b["merge_spmm_calls"],
                counts_b["carry"]) != (counts_b["K4"], counts_b["K2"],
                                       counts_b["K4"] + counts_b["K2"]):
            raise AssertionError(f"serve B's merge multiplies did not all go"
                                 f" through the fused entries: {counts_b}")
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
    torch.cuda.empty_cache()

    # phase 11: multi-tenant fleet serving (K1; K8 before and after a
    # re-deal)
    fleet_rows = run_fleet(f"{8.0 / div:g}")

    # phase 12: the autotuner and its break-even, then PageRank
    tune_row = run_autotune(8.0 / div, 14 if args.quick else 20, reps)
    torch.cuda.empty_cache()

    # phase 13: the SSM mixer served and trained (mamba2-1.3b), the jamba
    # hybrid through K9, the train_lm example's sparse-mixer phase
    ssm_row = run_ssm_train(args.quick)
    torch.cuda.empty_cache()

    # phase 14: the LM mesh (EP dispatch through K9, train --mesh 2x2)
    mesh_lm_row = run_lm_mesh(args.quick, reps)

    launches = {"K1": counts_a["K1"], "K2": counts_b["K2"],
                "K3": gmres_row["launches"]["K3"]
                + grad_row["launches"]["K3"],
                "K4": counts_b["K4"], "carry": counts_b["carry"],
                **blocked_row["launches"],
                "K8": mesh_row["launches"]["K8"],
                "K9": lm_row["reduced_f32"]["launches"]["K9"]
                + lm_row["reduced_f32"]["launches"]["K9d"],
                "K9w": lm_row["launches"]["K9w"]
                + mesh_lm_row["ep"]["launches"]["K9w"]}
    table["K9"]["decode_launches"] = lm_row["reduced_f32"]["launches"]["K9d"]
    kernels = []
    for key in ("K1", "K2", "K3", "K4", "carry", "K5", "K6", "K7", "K8",
                "K9", "K9w"):
        nm, src, rep = KERNEL_META[key]
        row = table[key]
        entry = {"name": nm, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[key],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"]}
        for extra in ("tile_gb_per_s", "per_shard_ms", "gather_bound_ms",
                      "device_ms", "library_device_ms",
                      "unpermute_ms", "decode_ms", "decode_plain_ms",
                      "decode_bound_ms", "decode_library_ms",
                      "decode_tiled_ms", "decode_launches",
                      "f32_fma_bound_ms", "f64_err", "tiled_f64_err"):
            if extra in row:
                entry[extra] = row[extra]
        kernels.append(entry)
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"rows": shape_rows, "serve": serve_rows,
                      "symmetric": sym_row, "gmres": gmres_row,
                      "autograd": grad_row, "blocked": blocked_row,
                      "mesh": mesh_row, "lm": lm_row, "fleet": fleet_rows,
                      "autotune": tune_row, "ssm": ssm_row,
                      "lm_mesh": mesh_lm_row}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
