"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; last, ``checks``:
each number compared beside its limit, also printed as the last lines of
standard error. Exits non-zero, with no result line, without a CUDA card
for the cell, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache stays inside the checkout, at fixed paths
# (the port builds its kernels into ROOT/build/repro_torch)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import torch  # noqa: E402

from benchlib.cell import read_metrics, run_cell  # noqa: E402
from benchlib.spec import load_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is the port and is allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _finite(v):
    """The result with every NaN or infinity written as a string, so that
    the line stays strict JSON."""
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    return v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda:0",
                   t_start=T_START)
    run = out.run
    print(f"bench: {args.workload} seed {args.seed}: {run.shape[0]} rows, "
          f"{run.nnz} nnz, setup_s {run.setup_s:.3f} (convert_s "
          f"{run.convert_s:.3f}), attempted {out.attempted}",
          file=sys.stderr)
    metrics = read_metrics(cell.per_layer if args.trace
                           else cell.end_to_end, run)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": power_limit()}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.missing + out.wrong, "metrics": metrics,
              "device": device}
    if args.trace:
        t = run.trace
        if t is None:
            print("bench: the profiler's trace held no device operation",
                  file=sys.stderr)
            return 4
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": [list(p) for p in t.device_ops],
                               "idle_gaps": [list(p) for p in t.idle_gaps]}
    result["checks"] = out.checks()

    found = forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
