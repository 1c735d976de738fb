"""Multi-pod dry run (the port of ``repro.launch.dryrun``): lower and
"compile" every (architecture x input shape) cell for the production
meshes and record memory, cost, collective and roofline analysis.

The reference compiles each cell with XLA for 256 or 512 placeholder host
devices. The port lays the same production mesh over ``meta`` positions
(``make_production_mesh(devices=["meta"] * n)``): the cell's inputs are
``meta`` tensors with their shardings attached (``launch.steps.
input_specs``), and ``compile()`` runs the step once on them under the op
counter (``roofline.op_count``), so nothing is allocated at any width.
The record keeps the reference's keys: ``lower_s``, ``compile_s``, the
memory keys from the shardings (temporaries are not counted),
``hbm_bytes_per_device``, ``collectives``, ``roofline`` (H100 data-sheet
rates) and, in place of ``xla_cost_analysis``, ``op_count_analysis``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all [--multi-pod both] --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES, cells, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import lower_cell
from repro_torch.models.accounting import (attn_extra_flops,
                                           decode_model_flops,
                                           train_model_flops)
from repro_torch.roofline import analysis as ra


def model_flops_for(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    s = SHAPES[shape_name]
    if s.kind == "train":
        return train_model_flops(cfg, s.batch * s.seq) + \
            attn_extra_flops(cfg, s.batch, s.seq, train=True)
    if s.kind == "prefill":
        return train_model_flops(cfg, s.batch * s.seq) / 3.0 + \
            attn_extra_flops(cfg, s.batch, s.seq, train=False)
    return decode_model_flops(cfg, s.batch, s.seq)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             profile: str = "tp", grad_accum: int = 1) -> dict:
    t0 = time.time()
    chips = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["meta"] * chips)
    rec = {"arch": arch, "shape": shape_name, "profile": profile,
           "grad_accum": grad_accum,
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips}
    lowered = lower_cell(arch, shape_name, mesh, profile=profile,
                         grad_accum=grad_accum)
    rec["lower_s"] = round(time.time() - t0, 1)
    t1 = time.time()
    compiled = lowered.compile()
    rec["compile_s"] = round(time.time() - t1, 1)

    mem = compiled.memory_analysis()
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes"):
        v = getattr(mem, k, None)
        if v is not None:
            rec[k] = int(v)
    # bytes that must fit HBM per device: args (params/opt/cache shards)
    # + temps (not counted) + outputs
    rec["hbm_bytes_per_device"] = sum(
        rec.get(k, 0) for k in ("argument_size_in_bytes",
                                "output_size_in_bytes",
                                "temp_size_in_bytes"))
    print(f"[{arch} x {shape_name} x {rec['mesh']}] memory_analysis:")
    print(" ", mem)

    roof = ra.from_compiled(compiled, chips,
                            model_flops=model_flops_for(arch, shape_name))
    rec["collectives"] = {k: dict(v) for k, v in
                          ra.parse_collective_bytes(compiled).items()
                          if v["count"]}
    rec["roofline"] = roof.to_dict()
    cost = compiled.cost_analysis()
    rec["op_count_analysis"] = {"flops": float(cost["flops"]),
                                "bytes": float(cost["bytes accessed"]),
                                "dot_flops": compiled.counter.dot_flops
                                / chips}
    print(f"[{arch} x {shape_name} x {rec['mesh']}] counted: "
          f"flops={roof.flops_per_device:.3e} "
          f"bytes={roof.bytes_per_device:.3e} per device")
    print(f"  roofline: compute={roof.compute_s:.4f}s "
          f"memory={roof.memory_s:.4f}s collective={roof.collective_s:.4f}s"
          f" bottleneck={roof.bottleneck} "
          f"useful={roof.useful_flops_fraction:.3f} "
          f"roofline_fraction={roof.roofline_fraction:.3f}")
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all'")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None,
                    help="directory for per-cell JSON records")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON already exists (resume)")
    ap.add_argument("--profile", default="tp",
                    choices=["tp", "fsdp", "fsdp_seqp"],
                    help="sharding profile (fsdp = no TP)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per step")
    args = ap.parse_args(argv)

    if args.arch == "all":
        todo = [(a, s) for a, s, skip in cells()]
    else:
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
        todo = [(args.arch, s) for s in shapes
                if (args.arch, s, False) in cells()]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    failures = 0
    for arch, shape in todo:
        for mp in pods:
            mesh_tag = "2_16_16" if mp else "16_16"
            if args.skip_existing and args.out and os.path.exists(
                    os.path.join(args.out,
                                 f"{arch}__{shape}__{mesh_tag}.json")):
                continue
            try:
                rec = run_cell(arch, shape, mp, profile=args.profile,
                               grad_accum=args.grad_accum)
            except Exception as e:
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "error": repr(e)}
                traceback.print_exc()
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                name = f"{arch}__{shape}__{rec['mesh'].replace('x', '_')}"
                with open(os.path.join(args.out, name + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
