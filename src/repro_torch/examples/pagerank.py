"""PageRank on an RMAT graph — the paper's motivating SpMV workload (§1),
the port of ``examples/pagerank.py``.

Power iteration ``r <- d * A_norm r + (1 - d) / n`` through one
``repro_torch.spmm.SparseOperator``: it starts on the zero-conversion
merge-path CSR plan (on the card K2 and the carry step: the operator
multiplies a vector as a one-column SpMM, as the reference's does), is
swapped to SELL-C-σ mid-stream (K1), and both rank vectors must agree
within 1e-5: the §7 break-even argument in action, and a plan swap that
never changes the math.

Run:  PYTHONPATH=src python -m repro_torch.examples.pagerank   # the card
      PYTHONPATH=src python -m repro_torch.examples.pagerank \\
          --device cpu --scale 10
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import PlanSpec, resolve_device, to_coo
from repro_torch.core.selector import ZERO_CONVERSION_ALGO
from repro_torch.data import matrices
from repro_torch.spmm import IMPLS, SparseOperator

DAMP = 0.85
ATOL = 1e-5          # the two plans' rank vectors agree within this


def pagerank(op, n: int, iters: int, label: str) -> torch.Tensor:
    dev = op.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = DAMP * (op @ r) + (1 - DAMP) / n
        r = r / torch.sum(r)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"  {label:16s} {iters} iterations in {dt * 1e3:.1f} ms "
          f"({dt / iters * 1e3:.3f} ms/iter)")
    return r


def main(argv=None) -> dict:
    """Run both legs; returns ``{"r1", "r2", "stats", "plans",
    "convert_s"}`` (the rank vectors before and after the swap, the
    operator's stats, both plan labels, the seconds of the start plan
    and of the swapped-in one)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the CPU)")
    ap.add_argument("--scale", type=int, default=13,
                    help="RMAT scale: the graph has 2**scale nodes")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--impl", default="auto", choices=IMPLS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # column-normalized adjacency (column-stochastic)
    rows, cols, _, shape = matrices.rmat(scale=args.scale, edge_factor=12,
                                         seed=0)
    n = shape[0]
    out_deg = np.bincount(cols, minlength=n).astype(np.float32)
    coo = to_coo(rows, cols, 1.0 / np.maximum(out_deg[cols], 1.0), shape,
                 device=dev)

    # zero-conversion start: merge-path CSR costs one row sort
    t0 = time.perf_counter()
    op = SparseOperator.from_coo(
        coo, PlanSpec(num_devices=1, algorithm=ZERO_CONVERSION_ALGO),
        impl=args.impl, k_hint=1, num_spmvs=args.iters)
    t_start = time.perf_counter() - t0
    first = op.plan.label
    r1 = pagerank(op, n, args.iters, first)

    # mid-stream migration: build the SELL-C-σ plan and swap it in; the
    # next multiply uses it
    t0 = time.perf_counter()
    op.swap(PlanSpec(num_devices=1, algorithm="sellcs"))
    t_swap = time.perf_counter() - t0
    print(f"conversion: {first} {t_start * 1e3:.0f} ms at start, "
          f"{op.plan.label} {t_swap * 1e3:.0f} ms swapped in after "
          f"{op.stats.multiplies} multiplies")
    r2 = pagerank(op, n, args.iters, op.plan.label)
    err = float((r1 - r2).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"the plans' ranks differ by {err:.3g}")
    print(f"operator stats: {op.stats}")
    top = torch.argsort(-r1)[:5]
    print(f"top-5 nodes: {top.tolist()}; rank mass "
          f"{float(r1[top].sum()):.4f}; plans differ by {err:.3g}")
    print("pagerank OK")
    return {"r1": r1, "r2": r2, "stats": op.stats,
            "plans": (first, op.plan.label), "convert_s": (t_start, t_swap)}


if __name__ == "__main__":
    main()
