"""Restarted GMRES over the port's sparse core — the paper's §1 motivating
workload ("iterative methods for sparse linear systems such as GMRES").

Solves (I + 0.05·A_norm) x = b on an RMAT graph with GMRES(20), then the
adjoint system (I + 0.05·A_norm^T) y = b — both through ONE
``repro_torch.spmm.SparseOperator`` handle: the plan is realized once,
``op @ v`` drives the forward solve and ``op.T @ v`` the transposed one
over the same stored stream (no second conversion — the operator stats
prove it). A_norm divides each entry by the in-degree of its column.

Run:  PYTHONPATH=src python -m repro_torch.examples.gmres --device cpu \\
          --impl plain                       # the kernels' plain versions
      PYTHONPATH=src python -m repro_torch.examples.gmres \\
          --scale 20 --algorithm sellcs      # on the card: K1 and K3
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import PlanSpec, resolve_device, to_coo
from repro_torch.data import matrices
from repro_torch.spmm import IMPLS, SparseOperator

TOL_RES = 1e-5       # relative residual each solve must reach


def shifted(op):
    """(I + 0.05 op) v — diagonally dominant, guaranteed convergence."""
    return lambda v: v + 0.05 * (op @ v)


def gmres(op, b, m=20, restarts=10, tol=1e-8):
    x = torch.zeros_like(b)
    for outer in range(restarts):
        r = b - op(x)
        beta = float(torch.linalg.norm(r))
        if beta < tol:
            break
        V = [r / beta]
        H = np.zeros((m + 1, m))
        for j in range(m):
            w = op(V[j])
            for i in range(j + 1):                 # modified Gram-Schmidt
                H[i, j] = float(torch.dot(V[i], w))
                w = w - H[i, j] * V[i]
            H[j + 1, j] = float(torch.linalg.norm(w))
            if H[j + 1, j] < 1e-12:
                m = j + 1
                break
            V.append(w / H[j + 1, j])
        e1 = np.zeros(m + 1)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H[: m + 1, :m], e1, rcond=None)
        x = x + torch.stack(V[:m], dim=1) @ torch.as_tensor(
            y, dtype=b.dtype, device=b.device)
        res = float(torch.linalg.norm(b - op(x)))
        print(f"  restart {outer}: residual {res:.3e}")
        if res < tol:
            break
    return x


def main(argv=None) -> dict:
    """Run both solves; returns ``{"residual", "residual_t", "stats",
    "plan"}`` (relative residuals of the forward and adjoint solves, the
    operator's :class:`OperatorStats`, the plan's label)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for the CPU)")
    ap.add_argument("--scale", type=int, default=12,
                    help="RMAT scale: the matrix has 2**scale rows")
    ap.add_argument("--algorithm", default=None,
                    help="pin the plan's format (default: the selector's)")
    ap.add_argument("--impl", default="auto", choices=IMPLS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows, cols, _, shape = matrices.rmat(scale=args.scale, edge_factor=10,
                                         seed=0)
    n = shape[0]
    deg = np.bincount(cols, minlength=n).astype(np.float32)
    coo = to_coo(rows, cols, 1.0 / np.maximum(deg[cols], 1.0), shape,
                 device=dev)

    t0 = time.perf_counter()
    A = SparseOperator.from_coo(
        coo, PlanSpec(num_devices=1, algorithm=args.algorithm),
        impl=args.impl, k_hint=1, num_spmvs=500)
    print(f"operator plan: {A.plan.label} ({A.plan.impl}, "
          f"{(time.perf_counter() - t0) * 1e3:.0f} ms to realize)")

    b = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    x = gmres(shifted(A), b)
    res = float(torch.linalg.norm(b - shifted(A)(x)) / torch.linalg.norm(b))
    print(f"forward GMRES done in {time.perf_counter() - t0:.2f}s, "
          f"relative residual {res:.2e}")
    if not res < TOL_RES:
        raise AssertionError(f"forward GMRES residual {res:.3e}")

    # adjoint solve through the SAME plan: op.T shares the realized
    # stream, so the stats show no build across it
    builds_before = A.stats.sellcs_builds
    t0 = time.perf_counter()
    y = gmres(shifted(A.T), b)
    res_t = float(torch.linalg.norm(b - shifted(A.T)(y))
                  / torch.linalg.norm(b))
    print(f"adjoint GMRES done in {time.perf_counter() - t0:.2f}s, "
          f"relative residual {res_t:.2e}")
    if not res_t < TOL_RES:
        raise AssertionError(f"adjoint GMRES residual {res_t:.3e}")
    if A.stats.sellcs_builds != builds_before:
        raise AssertionError("transpose must not rebuild")
    print(f"operator stats: {A.stats}")
    print("gmres OK")
    return {"residual": res, "residual_t": res_t, "stats": A.stats,
            "plan": A.plan.label}


if __name__ == "__main__":
    main()
