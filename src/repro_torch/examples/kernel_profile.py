"""K3 (the SELL-C-σ transpose) and K9 (the grouped GEMM) at the main path's
shapes on the card, timed per call with the host's issue time hidden, so
that two trees can be compared on one card (the other tree's package on
the path, this file run as a script):

    python -m repro_torch.examples.kernel_profile
    PYTHONPATH=<other tree>/src \\
        python src/repro_torch/examples/kernel_profile.py

The first launches are K9's (one granite decode step's gate product, 32
tokens x top-8 over 32 experts, bf16 rows, f32 weights: the decode kernel
where the tree has one, then the tiled kernel), then K3 on hhh_like
--scale 64 at k = 32 (the main path's shape), then the other widths and
matrices (mawi_like --scale 4, road_like --scale 8, rmat scale 20 as the
GMRES example builds it). ``device_ms`` is one call's device time: the
launches are queued behind a sleeping kernel, so they run back to back
however slowly the host issues them; ``events_ms`` is the mean of the
same calls issued at the host's pace. The last line is one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

REPS = 20
SLEEP_CYCLES = 200_000_000      # ~0.1 s at the SM clock: the queue fills


def device_ms(fn, reps: int = REPS) -> float:
    """One call's device time: ``reps`` calls queued behind a sleeping
    kernel run back to back, timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, reps: int = REPS) -> float:
    """The mean of ``reps`` calls issued at the host's pace."""
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


def k9_rows() -> list:
    """K9 on one granite decode step's gate/up and down products."""
    from repro_torch.kernels import moe_group_matmul as MG
    from repro_torch.kernels import ops as KO
    gen = torch.Generator(device="cuda").manual_seed(2024)
    E, top, tokens = 32, 8, 32
    p = 1.0 / torch.arange(1, E + 1, device="cuda",
                           dtype=torch.float32) ** 1.2
    sizes = torch.bincount(torch.multinomial(
        p.expand(tokens, E), top, replacement=False,
        generator=gen).reshape(-1), minlength=E)
    out = []
    for name, K, N in (("gate_up", 1024, 512), ("down", 512, 1024)):
        xs = torch.randn((tokens * top, K), generator=gen,
                         device="cuda").to(torch.bfloat16)
        w = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
        gp = KO.moe_group_pad(xs, sizes, E, K)
        fns = {"tiled": lambda: MG.moe_group_matmul_padded(
            gp.lhs, w, gp.tile_expert, n_rows=gp.n_rows)}
        decode = getattr(MG, "moe_group_matmul_decode", None)
        if decode is not None:
            fns = {"decode": lambda: decode(gp.lhs, w, gp.tile_expert,
                                            gp.tile_rows, n_rows=gp.n_rows),
                   **fns}
        for kern, fn in fns.items():
            out.append({"kernel": f"K9 {kern}", "case": f"decode/{name}",
                        "device_ms": device_ms(fn),
                        "events_ms": events_ms(fn)})
            print(f"[kernel_profile] {out[-1]}", flush=True)
    return out


def _sellcs(name: str, scale: float):
    from repro_torch.core import to_coo
    from repro_torch.data import matrices
    from repro_torch.spmm.sellcs import coo_to_sellcs
    if name == "rmat":
        rows, cols, _, shape = matrices.rmat(scale=int(scale),
                                             edge_factor=10, seed=0)
        deg = np.bincount(cols, minlength=shape[1]).astype(np.float32)
        coo = to_coo(rows, cols, 1.0 / np.maximum(deg[cols], 1.0), shape,
                     device="cuda")
    else:
        coo = matrices.as_coo(matrices.test_suite(scale)[name].make(),
                              device="cuda")
    return coo_to_sellcs(coo)


def k3_rows() -> list:
    """K3 (Y = A^T X from the stored SELL-C-σ) at each matrix and k."""
    from repro_torch.spmm import kernels as SK
    from repro_torch.spmm.reference import sellcs_slot_x
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = []
    for name, scale, ks in (("hhh_like", 64.0, (32, 1, 8, 16, 33)),
                            ("mawi_like", 4.0, (1, 8, 32)),
                            ("road_like", 8.0, (1, 8, 32)),
                            ("rmat", 20, (1,))):
        sc = _sellcs(name, scale)
        m, n = sc.shape
        for k in ks:
            xs = sellcs_slot_x(sc.row_perm, torch.randn(
                (m, k), generator=gen, device="cuda"), m)

            def fn():
                return SK.sellcs_slots_t(sc.data, sc.cols, sc.slice_of,
                                         sc.slice_ptr, sc.row_len, xs,
                                         n_out=n, chunk=sc.chunk)
            out.append({"kernel": "K3", "matrix": name, "scale": scale,
                        "k": k, "device_ms": device_ms(fn),
                        "events_ms": events_ms(fn)})
            print(f"[kernel_profile] {out[-1]}", flush=True)
            del xs
        del sc
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("[kernel_profile] needs a CUDA device", file=sys.stderr)
        return 2
    rows = k9_rows() + k3_rows()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
