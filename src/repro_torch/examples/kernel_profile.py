"""K1/K8 (SELL-C-σ SpMM and its fused-gather form), K2 (merge-path CSR
SpMM), K3 (the SELL-C-σ transpose) and K9 (the grouped GEMM) at the main
path's shapes on the card, timed per call with the host's issue time
hidden, so that two trees can be compared on one card (the other tree's
package on the path, this file run as a script):

    python -m repro_torch.examples.kernel_profile
    PYTHONPATH=<other tree>/src \\
        python src/repro_torch/examples/kernel_profile.py [--only k1,k8]

The first launches are K9's: one granite decode step's gate and down
products (32 tokens x top-8 over 32 experts, bf16 rows, f32 weights),
then the prefill's (4,096 tokens), each through the tensor-core kernel
and the decode kernel (decode only) where the tree has them, then the
SIMT tiled kernel. Then K2 on hhh_like --scale 64, mawi_like
--scale 4 and road_like --scale 8 at k = 8, 16, 32 and 33 (each
matrix's own merge plan), then K3 on hhh_like --scale 64 at k = 32 (the
main path's shape), the other widths and matrices (mawi_like --scale 4,
road_like --scale 8, rmat scale 20 as the GMRES example builds it), then
K1 on the phase-2 matrices at k = 1, 8, 16, 32 and 33 as ``sellcs_spmm``
calls it (with ``row_len`` where the tree's wrapper takes it), and K8 on
the four row shards of hhh_like --scale 64 (compact X) at k = 32, per
shard and summed. ``--depths 8,16,32`` also times K1 over plans of those
item depths (trees with ``spmm.slots_plan`` only).
``--only paths`` times the single-vector paths K1 sits on at the host's
pace instead: ``sellcs_spmm`` at k = 1 on the phase-2 matrices, a
forward GMRES solve at rmat scale 20 (per K1 launch) and serve A's
batched and sequential legs. ``--only merge`` times the merge-path
multiply as its user calls it (``kernels.ops.merge_spmv`` at k = 1,
``spmm.csr_spmm`` at k = 1, 8, 32 and 33: the partials kernel and the
carry step) on the phase-2 matrices, with the host's time to issue a
call (``host_us``), and the standalone carry step
(``merge_spmv.carry_out_fixup``) against ``index_add_`` at k = 1 and 32;
every function it calls exists in trees before and after the carry
step's redesign. ``--only`` picks groups (k9, k2, k3, k1, k8, paths,
merge; the default is every kernel group). ``device_ms`` is one call's
device time: the launches are queued behind a sleeping kernel, so they
run back to back however slowly the host issues them; ``events_ms`` is
the mean of the same calls issued at the host's pace. The last line is
one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
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


def host_us(fn, reps: int = REPS) -> float:
    """Microseconds the host takes to issue one call (``reps`` calls, no
    synchronize in the window)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def merge_rows(reps: int = 200) -> list:
    """The merge-path multiply through its entry points and the carry step
    alone, on each phase-2 matrix's own merge plan."""
    from repro_torch.core import coo_to_csr
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.kernels import ops as KO
    from repro_torch.spmm import csr_spmm
    from repro_torch.spmm import kernels as SK
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out = []
    for name, scale in (("hhh_like", 64.0), ("mawi_like", 4.0),
                        ("road_like", 8.0)):
        coo = _coo(name, scale)
        m, n = coo.shape
        csr = coo_to_csr(coo)
        plan = MS.cached_merge_plan(csr)
        cases = [("merge_spmv", 1)] + [("csr_spmm", k) for k in
                                       (1, 8, 32, 33)]
        for path, k in cases:
            X = torch.randn((n, k), generator=gen, device="cuda")
            x1 = X[:, 0].contiguous()
            if path == "merge_spmv":
                def fn():
                    return KO.merge_spmv(csr, x1)
            else:
                def fn():
                    return csr_spmm(csr, X)
            out.append({"path": path, "matrix": name, "scale": scale,
                        "k": k, "host_us": host_us(fn, reps),
                        "events_ms": events_ms(fn, reps),
                        "device_ms": device_ms(fn, reps)})
            print(f"[kernel_profile] {out[-1]}", flush=True)
            if k in (1, 32) and path == "csr_spmm":
                y, cr, cv = SK._merge_spmm_partials(plan, X, m)
                keep = cr >= 0
                rows_kept, vals_kept = cr[keep].long(), cv[keep]

                def fix():
                    return MS.carry_out_fixup(y, cr, cv)

                def lib():
                    return y.index_add_(0, rows_kept, vals_kept)
                out.append({"path": "carry_out_fixup", "matrix": name,
                            "scale": scale, "k": k,
                            "host_us": host_us(fix, reps),
                            "events_ms": events_ms(fix, reps),
                            "device_ms": device_ms(fix, reps),
                            "library_events_ms": events_ms(lib, reps),
                            "library_device_ms": device_ms(lib, reps)})
                print(f"[kernel_profile] {out[-1]}", flush=True)
                del y, cr, cv, rows_kept, vals_kept
            del X, x1
        del coo, csr, plan
        torch.cuda.empty_cache()
    return out


def k9_rows() -> list:
    """K9 on one granite decode step's and one prefill's gate/up and down
    products, through each kernel the tree has for them."""
    from repro_torch.kernels import moe_group_matmul as MG
    from repro_torch.kernels import ops as KO
    gen = torch.Generator(device="cuda").manual_seed(2024)
    E, top = 32, 8
    p = 1.0 / torch.arange(1, E + 1, device="cuda",
                           dtype=torch.float32) ** 1.2
    out = []
    for phase, tokens in (("decode", 32), ("prefill", 4096)):
        sizes = torch.bincount(torch.multinomial(
            p.expand(tokens, E), top, replacement=False,
            generator=gen).reshape(-1), minlength=E)
        for name, K, N in (("gate_up", 1024, 512), ("down", 512, 1024)):
            xs = torch.randn((tokens * top, K), generator=gen,
                             device="cuda").to(torch.bfloat16)
            w = torch.randn((E, K, N), generator=gen,
                            device="cuda") * K ** -0.5
            gp = KO.moe_group_pad(xs, sizes, E, K)
            fns = {}
            wgmma = getattr(MG, "moe_group_matmul_wgmma", None)
            if wgmma is not None:
                fns["wgmma"] = lambda: wgmma(gp.lhs, w, gp.tile_expert,
                                             n_rows=gp.n_rows)
            decode = getattr(MG, "moe_group_matmul_decode", None)
            if decode is not None and phase == "decode":
                fns["decode"] = lambda: decode(gp.lhs, w, gp.tile_expert,
                                               gp.tile_rows,
                                               n_rows=gp.n_rows)
            fns["tiled"] = lambda: MG.moe_group_matmul_padded(
                gp.lhs, w, gp.tile_expert, n_rows=gp.n_rows)
            for kern, fn in fns.items():
                out.append({"kernel": f"K9 {kern}",
                            "case": f"{phase}/{name}",
                            "device_ms": device_ms(fn),
                            "events_ms": events_ms(fn)})
                print(f"[kernel_profile] {out[-1]}", flush=True)
            del xs, w, gp
            torch.cuda.empty_cache()
    return out


def k2_rows() -> list:
    """K2 (the merge-path partials, the carry step not included) on each
    phase-2 matrix's own merge plan at k = 8, 16, 32 and 33."""
    from repro_torch.core import coo_to_csr
    from repro_torch.data import matrices
    from repro_torch.kernels import merge_spmv as MS
    from repro_torch.spmm import kernels as SK
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = []
    for name, scale in (("hhh_like", 64.0), ("mawi_like", 4.0),
                        ("road_like", 8.0)):
        coo = matrices.as_coo(matrices.test_suite(scale)[name].make(),
                              device="cuda")
        m, n = coo.shape
        csr = coo_to_csr(coo)
        plan = MS.cached_merge_plan(csr)
        for k in (32, 8, 16, 33):
            X = torch.randn((n, k), generator=gen, device="cuda")

            def fn():
                return SK._merge_spmm_partials(plan, X, m)
            out.append({"kernel": "K2", "matrix": name, "scale": scale,
                        "k": k, "device_ms": device_ms(fn),
                        "events_ms": events_ms(fn)})
            print(f"[kernel_profile] {out[-1]}", flush=True)
            del X
        del coo, csr, plan
        torch.cuda.empty_cache()
    return out


def _coo(name: str, scale: float):
    from repro_torch.core import to_coo
    from repro_torch.data import matrices
    if name == "rmat":
        rows, cols, _, shape = matrices.rmat(scale=int(scale),
                                             edge_factor=10, seed=0)
        deg = np.bincount(cols, minlength=shape[1]).astype(np.float32)
        return to_coo(rows, cols, 1.0 / np.maximum(deg[cols], 1.0), shape,
                      device="cuda")
    return matrices.as_coo(matrices.test_suite(scale)[name].make(),
                           device="cuda")


def _sellcs(name: str, scale: float):
    from repro_torch.spmm.sellcs import coo_to_sellcs
    return coo_to_sellcs(_coo(name, scale))


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


K1_KS = (1, 8, 16, 32, 33)


def _k1_kwargs(sc) -> dict:
    """``row_len=`` where the tree's K1 wrapper takes it."""
    from repro_torch.spmm import kernels as SK
    params = inspect.signature(SK.sellcs_slots).parameters
    return {"row_len": sc.row_len} if "row_len" in params else {}


def k1_rows(depths=()) -> list:
    """K1 on each phase-2 matrix at k = 1, 8, 16, 32 and 33, as
    ``sellcs_spmm`` launches it, and over plans of other item depths."""
    from repro_torch.spmm import kernels as SK
    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = []
    for name, scale in (("hhh_like", 64.0), ("mawi_like", 4.0),
                        ("road_like", 8.0)):
        sc = _sellcs(name, scale)
        n = sc.shape[1]
        kw = dict(num_slices=sc.num_slices, chunk=sc.chunk, **_k1_kwargs(sc))
        for k in K1_KS:
            X = torch.randn((n, k), generator=gen, device="cuda")

            def fn():
                return SK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X,
                                       **kw)
            out.append({"kernel": "K1", "matrix": name, "scale": scale,
                        "k": k, "device_ms": device_ms(fn),
                        "events_ms": events_ms(fn)})
            print(f"[kernel_profile] {out[-1]}", flush=True)
            for d in depths:
                from repro_torch.spmm import slots_plan as SP
                plan = SP.build_slots_plan(
                    sc.slice_ptr, num_slices=sc.num_slices, chunk=sc.chunk,
                    row_len=sc.row_len, depth=d)
                y = torch.empty((sc.num_slices * sc.chunk, k),
                                device="cuda")

                def fd():
                    SK._sellcs_slots_launch(plan, sc.data, sc.cols, X, y)
                out.append({"kernel": f"K1 D={d}", "matrix": name,
                            "scale": scale, "k": k, "items": plan.n_items,
                            "segments": plan.n_segs,
                            "device_ms": device_ms(fd),
                            "events_ms": events_ms(fd)})
                print(f"[kernel_profile] {out[-1]}", flush=True)
            del X
        del sc
        torch.cuda.empty_cache()
    return out


def k8_rows() -> list:
    """K8 on the four row shards (compact X) of hhh_like --scale 64 at
    k = 32, with each shard's ``row_len`` and depth base where the tree's
    wrapper takes them; per shard and summed."""
    from repro_torch.spmm import distributed as TD
    from repro_torch.spmm import kernels as SK
    gen = torch.Generator(device="cuda").manual_seed(4242)
    sc = _sellcs("hhh_like", 64.0)
    part = TD.partition_sellcs_rows(sc, 4, compact_x=True)
    X = torch.randn((sc.shape[1], 32), generator=gen, device="cuda")
    takes = "row_len" in inspect.signature(SK.sellcs_slots).parameters
    out, total = [], 0.0
    for p, sh in enumerate(part.shards):
        kw = dict(num_slices=sh.num_slices, chunk=part.chunk,
                  col_map=sh.col_map)
        if takes:
            kw.update(row_len=sh.t_row_len, depth_ptr=sh.t_ptr)

        def fn():
            return SK.sellcs_slots(sh.data, sh.cols, sh.slice_ptr, X, **kw)
        out.append({"kernel": "K8", "matrix": "hhh_like", "scale": 64.0,
                    "k": 32, "shard": p, "device_ms": device_ms(fn),
                    "events_ms": events_ms(fn)})
        total += out[-1]["device_ms"]
        print(f"[kernel_profile] {out[-1]}", flush=True)
    out.append({"kernel": "K8", "matrix": "hhh_like", "scale": 64.0,
                "k": 32, "shard": "sum", "device_ms": total})
    print(f"[kernel_profile] {out[-1]}", flush=True)
    del part, sc, X
    torch.cuda.empty_cache()
    return out


def path_rows() -> list:
    """The single-vector paths K1 sits on, at the host's pace: the whole
    SELL-C-σ multiply (``sellcs_spmm``: K1, then the un-permute) at k = 1
    on the phase-2 matrices; one forward GMRES solve at rmat scale 20 as
    the GMRES example runs it, after a warm-up solve, per solve and per
    K1 launch; serve A (hhh_like --scale 64, 256 requests, batches of 32,
    SELL-C-σ pinned), batched and sequential."""
    import time
    from repro_torch.core import PlanSpec
    from repro_torch.examples import gmres as G
    from repro_torch.launch import serve
    from repro_torch.spmm import SparseOperator
    from repro_torch.spmm import kernels as SK
    gen = torch.Generator(device="cuda").manual_seed(77)
    out = []
    for name, scale in (("hhh_like", 64.0), ("mawi_like", 4.0),
                        ("road_like", 8.0)):
        sc = _sellcs(name, scale)
        x = torch.randn((sc.shape[1], 1), generator=gen, device="cuda")

        def fn():
            return SK.sellcs_spmm(sc, x)
        out.append({"path": "sellcs_spmm", "matrix": name, "scale": scale,
                    "k": 1, "events_ms": events_ms(fn, 200),
                    "device_ms": device_ms(fn, 200)})
        print(f"[kernel_profile] {out[-1]}", flush=True)
        del sc, x
    coo = _coo("rmat", 20)
    A = SparseOperator.from_coo(coo, PlanSpec(num_devices=1,
                                              algorithm="sellcs"),
                                k_hint=1, num_spmvs=500)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        coo.shape[0]).astype(np.float32)).to("cuda")
    G.gmres(G.shifted(A), b)
    torch.cuda.synchronize()
    k1 = SK.sellcs_slots.launches
    t0 = time.perf_counter()
    G.gmres(G.shifted(A), b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = SK.sellcs_slots.launches - k1
    out.append({"path": "gmres", "matrix": "rmat", "scale": 20,
                "solve_ms": secs * 1e3, "k1_launches": n,
                "ms_per_launch": secs * 1e3 / max(n, 1)})
    print(f"[kernel_profile] {out[-1]}", flush=True)
    del A, coo, b
    torch.cuda.empty_cache()
    res = serve.main(["--mode", "spmv", "--matrix", "hhh_like", "--scale",
                      "64", "--requests", "256", "--max-batch", "32",
                      "--reps", "2", "--algorithm", "sellcs",
                      "--device", "cuda"])
    out.append({"path": "serve A", "matrix": "hhh_like", "scale": 64.0,
                "batched_ms": res["t_batched"] * 1e3,
                "sequential_ms": res["t_seq"] * 1e3})
    print(f"[kernel_profile] {out[-1]}", flush=True)
    del res
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="k9,k2,k3,k1,k8",
                    help="comma-separated groups: k9, k2, k3, k1, k8, "
                         "paths, merge")
    ap.add_argument("--depths", default="",
                    help="comma-separated K1 item depths to time too")
    args = ap.parse_args(argv)
    groups = args.only.split(",")
    depths = [int(d) for d in args.depths.split(",") if d]
    if not torch.cuda.is_available():
        print("[kernel_profile] needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for name, fn in (("k9", k9_rows), ("k2", k2_rows), ("k3", k3_rows),
                     ("k1", lambda: k1_rows(depths)), ("k8", k8_rows),
                     ("paths", path_rows), ("merge", merge_rows)):
        if name in groups:
            rows += fn()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
