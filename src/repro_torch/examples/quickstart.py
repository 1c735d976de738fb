"""Quickstart: the paper's pipeline end to end on one unstructured matrix.

  1. make an unstructured sparse matrix (by default the power-law
     4096 x 4096 matrix with 65,536 nonzeros of ``examples/quickstart.py``;
     ``--matrix``/``--scale`` take one of the suite's instead);
  2. inspect its stats and let the paper's §7 selector pick an algorithm;
  3. convert (the paper's conversion phase) and multiply with every
     algorithm;
  4. check every answer against the dense oracle (the triplet oracle when
     the matrix is too large to densify), computed in float64;
  5. convert to the tiled compute format and multiply through K5 (the
     CUDA kernel on the card, its plain version on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
      PYTHONPATH=src python -m repro_torch.examples.quickstart \\
          --matrix road_like --scale 8          # on the card, 1 M rows
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import (ALGORITHM_SPECS, MachineSpec, convert,
                              matrix_stats, resolve_device, select_algorithm,
                              spmv, spmv_coo, spmv_dense_oracle, to_coo)
from repro_torch.data import matrices
from repro_torch.kernels import coo_to_tiled, ops

DENSE_MAX = 1 << 26     # largest m * n the dense oracle densifies
TOL_REL = 1e-4          # max|y - y_ref| <= TOL_REL * max(1, max|y_ref|)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default=None,
                    help="a suite matrix (default: the power-law 4096^2)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="suite scale of --matrix")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. an unstructured matrix
    if args.matrix is None:
        trip = matrices.powerlaw(4096, 4096, 65536, seed=0)
    else:
        suite = matrices.test_suite(args.scale)
        if args.matrix not in suite:
            raise SystemExit(f"--matrix must be one of {sorted(suite)}")
        trip = suite[args.matrix].make()
    coo = to_coo(*trip, device=dev)
    m, n = coo.shape
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n)
                         .astype(np.float32)).to(dev)
    dense = m * n <= DENSE_MAX
    # float64: a float32 oracle's own error on a long row (mawi_like's
    # dense row) is as large as the tolerance
    x64 = x.double()
    y_ref = spmv_dense_oracle(coo, x64) if dense else spmv_coo(coo, x64)
    tol = TOL_REL * max(1.0, float(y_ref.abs().max()))

    # 2. stats + algorithm selection (the paper's decision procedure)
    stats = matrix_stats(coo)
    print(f"matrix: {coo.shape}, nnz={stats.nnz}, density="
          f"{stats.density:.2e}, max_row={stats.max_row_nnz}, "
          f"var={stats.row_var:.1f}; oracle: "
          f"{'dense' if dense else 'triplets'}")
    pick_numa = select_algorithm(stats, MachineSpec(num_devices=256),
                                 num_spmvs=1000)
    pick_uma = select_algorithm(stats, MachineSpec(num_devices=1),
                                num_spmvs=1000)
    print(f"selector: mesh(256 devices) -> {pick_numa!r}; "
          f"single device -> {pick_uma!r}")

    # 3+4. convert + multiply with every algorithm, check
    errors, convert_s = {}, {}
    for algo, spec in ALGORITHM_SPECS.items():
        kw = {"num_bands": 8} if spec.scheduling == "static_rows" else {}
        t0 = time.perf_counter()
        mat = convert(coo, algo, **kw)
        convert_s[algo] = time.perf_counter() - t0
        y = spmv(mat, x)
        errors[algo] = float((y - y_ref).abs().max())
        extra = (f" storage={mat.storage_bytes() / 1e6:.2f}MB"
                 if hasattr(mat, "storage_bytes") else "")
        print(f"  {algo:8s} max err {errors[algo]:.2e} convert "
              f"{convert_s[algo]:.2f} s{extra}  [{spec.note}]")
        del mat
    bad = {a: e for a, e in errors.items() if not e <= tol}
    if bad:
        raise AssertionError(f"answers off the oracle by more than "
                             f"{tol:.3g}: {bad}")

    # 5. the tiled compute format, multiplied through K5
    t0 = time.perf_counter()
    ts = coo_to_tiled(coo, "csbh")
    tiled_s = time.perf_counter() - t0
    xsw, ysw = ts.window_switches()
    y_k = ops.bsr_spmv(ts, x)
    k5_err = float((y_k - y_ref).abs().max())
    print(f"tiled (csbh): {ts.num_tiles} 8x128 tiles, fill="
          f"{ts.fill_ratio:.4f}, window switches x={xsw} y={ysw}, "
          f"convert {tiled_s:.2f} s; bsr_spmv "
          f"({'kernel' if dev.type == 'cuda' else 'plain'}) max err "
          f"{k5_err:.2e}")
    if not k5_err <= tol:
        raise AssertionError(f"bsr_spmv off the oracle: {k5_err:.3g} > "
                             f"{tol:.3g}")
    print("quickstart OK")
    return {"shape": coo.shape, "nnz": stats.nnz, "pick": pick_uma,
            "errors": errors, "convert_s": convert_s, "tol": tol,
            "tiles": ts.num_tiles, "fill": ts.fill_ratio,
            "window_switches": (xsw, ysw), "tiled_s": tiled_s,
            "k5_err": k5_err}


if __name__ == "__main__":
    main()
