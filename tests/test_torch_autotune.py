"""The port's autotuner and its helpers against the JAX package on the
CPU: ``merge_path_partition`` and ``span_block_aligned`` (bitwise),
``merge_spmv_ref`` and ``merge_spmv_xla``, ``spmm_roofline_gflops``,
``_rescore_distributed`` with and without a ``ResidualLedger``,
``autotune``'s candidate grid and winner under the same measured
seconds, PageRank through a plan swap, and the package exports.

On the CPU ``autotune`` times each candidate through ``impl="auto"``,
which is the oracle there, as the reference's ``impl="ref"``; its
measured seconds differ from run to run, so the grid and the winner are
compared with ``_measure`` and the conversion clock patched to the same
deterministic values in both packages.

Tolerance: the merge-path SpMV realizations within ``1e-5 * max(1,
max|y|)`` of the reference's (float32 sums in another order); modelled
seconds within 1e-9 relative at the same rates; PageRank's two plans
within 1e-5 of each other and of the reference's power iteration.
"""
import functools
import importlib
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro import obs as JO
from repro.core import mergepath as JMP
from repro.kernels import merge_spmv as JMS
from repro.kernels import ref as JKR
from repro.roofline import analysis as JRA

from repro_torch import obs as TO
from repro_torch.core import coo_to_csr
from repro_torch.core import mergepath as TMP
from repro_torch.data import matrices as TM
from repro_torch.examples import pagerank
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import ref as TKR
from repro_torch.roofline import analysis as TRA

# the modules, not the functions the packages export under the same name
JA = importlib.import_module("repro.core.autotune")
TA = importlib.import_module("repro_torch.core.autotune")

CASES = {"uniform": lambda: TM.uniform(400, 350, 3000, 0),
         "mawi_like": lambda: TM.mawi_like(300, 300, 2000, 0.4, 1),
         "road_like": lambda: TM.mesh2d(20, 1)}

# names of the reference's package exports whose modules are not ported
# yet (ROADMAP.md, queue 1)
NOT_PORTED = {
    "core": set(), "spmm": set(),
    "launch": {"make_production_mesh"},
    "runtime": {"Supervisor", "build_mesh", "reshard"},
    "roofline": {"Roofline", "from_compiled", "parse_collective_bytes",
                 "collective_bytes_total"},
}


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair(name):
    trip = CASES[name]()
    return J.to_coo(*trip), TM.as_coo(trip, device="cpu")


@pytest.mark.parametrize("P", [1, 7, 64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_path_partition_bitwise(name, P):
    jc, tc = _pair(name)
    jcsr, tcsr = J.coo_to_csr(jc), coo_to_csr(tc)
    a = JMP.merge_path_partition(jcsr.row_ptr, P)
    b = TMP.merge_path_partition(tcsr.row_ptr, P)
    for f in a._fields:
        got = getattr(b, f)
        assert got.dtype == torch.int32, f
        assert np.array_equal(np.asarray(getattr(a, f)), got.numpy()), f
    # the host twin cuts the same path
    rs, ns = TMP.merge_path_partition_np(tcsr.row_ptr.numpy(), P)
    assert np.array_equal(rs, b.row_starts.numpy())
    assert np.array_equal(ns, b.nnz_starts.numpy())


@pytest.mark.parametrize("P", [1, 3, 16, 100])
def test_span_block_aligned_bitwise(P):
    rng = np.random.default_rng(P)
    ptr = np.concatenate([[0], np.cumsum(rng.integers(0, 40, 57))])
    ptr[20:25] = ptr[19]            # empty blocks
    ptr = np.maximum.accumulate(ptr)
    a = JMP.span_block_aligned(ptr, P)
    b = TMP.span_block_aligned(ptr, P)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("spans", [8, 33])
@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_spmv_ref_and_xla_match_reference(name, spans):
    jc, tc = _pair(name)
    jcsr, tcsr = J.coo_to_csr(jc), coo_to_csr(tc)
    m, n = tc.shape
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    want = np.asarray(JKR.merge_spmv_ref(jcsr, jnp.asarray(x)))
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    got = TKR.merge_spmv_ref(tcsr, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= tol
    jp, tp = JMS.merge_plan(jcsr, spans), TMS.merge_plan(tcsr, spans)
    assert jp.r_width == tp.r_width
    x_pad = np.concatenate([x, np.zeros(128, np.float32)])
    want = np.asarray(JKR.merge_spmv_xla(
        jp.cols, jp.vals, jp.seg, jp.row_starts, jnp.asarray(x_pad),
        r_width=jp.r_width, m=m))
    got = TKR.merge_spmv_xla(tp.cols, tp.vals, tp.seg, tp.row_starts,
                             torch.from_numpy(x_pad), r_width=tp.r_width,
                             m=m)
    assert got.dtype == torch.float32 and got.shape == (m,)
    assert np.abs(got.numpy() - want).max() <= tol


def test_spmm_roofline_gflops_equal_at_the_same_rates():
    for ai, peak, bw in itertools.product((0.01, 0.25, 3.0, 500.0),
                                          (67e12, 197e12), (3.35e12, 8e11)):
        assert TRA.spmm_roofline_gflops(ai, peak, bw) == \
            JRA.spmm_roofline_gflops(ai, peak, bw)
    # the port's defaults are the H100's float32 peak and HBM rate
    assert TRA.spmm_roofline_gflops(1e6) == TRA.PEAK_FLOPS_FP32 / 1e9
    assert TRA.spmm_roofline_gflops(1.0) == TRA.HBM_BW / 1e9


def _ledger(obs):
    led = obs.ResidualLedger()
    for sched, nc, mesh, cf, dt in (("merge", 2, (4, 1), False, 5.0),
                                    ("row", 1, (4, 1), False, 0.2),
                                    ("row", 1, (2, 2), True, 9.0),
                                    ("merge", 1, (4, 1), True, 0.5)):
        led.record("serve/flush", dt, 1.0, **obs.choice_labels(
            schedule=sched, num_chunks=nc, mesh_shape=mesh, compact_x=cf))
    return led


@pytest.mark.parametrize("fed", [False, True])
@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_rescore_distributed_matches_reference(monkeypatch, name, k, fed):
    """The same picks and modelled seconds at the reference's HBM and
    link rates (the traffic model is shared; only its constants are the
    H100's in the port)."""
    monkeypatch.setattr(TRA, "spmm_distributed_time", functools.partial(
        TRA.spmm_distributed_time, hbm_bw=JRA.HBM_BW,
        link_bw=JRA.ICI_LINK_BW))
    jc, tc = _pair(name)
    js, ts = J.matrix_stats(jc), TA.matrix_stats(tc)
    for algo in ("parcrs", "csb", "sellcs"):
        a = JA._rescore_distributed(
            JA.TuneResult(algo, None, 0.25, 1e-3, 0.0, k=k), js, k, 4,
            1000, feedback=_ledger(JO) if fed else None)
        b = TA._rescore_distributed(
            TA.TuneResult(algo, None, 0.25, 1e-3, 0.0, k=k), ts, k, 4,
            1000, feedback=_ledger(TO) if fed else None)
        for f in ("schedule", "num_chunks", "mesh_shape", "compact_x",
                  "structure", "gather", "num_devices", "residual"):
            assert getattr(a, f) == getattr(b, f), (algo, f)
        for f in ("dist_model_s", "total_s"):
            assert getattr(b, f) == pytest.approx(getattr(a, f), rel=1e-9)


class _Clock:
    """``time`` stand-in: perf_counter advances by one second a read, so
    every conversion measures exactly 1 s in both packages."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def _tune(mod, coo, monkeypatch, **kw):
    seq = itertools.count()
    monkeypatch.setattr(mod, "_measure", lambda fn, reps=5, warmup=2:
                        1e-3 * (1 + (next(seq) * 7) % 5))
    monkeypatch.setattr(mod, "time", _Clock())
    return mod.autotune(coo, num_spmvs=100, reps=1, **kw)


@pytest.mark.parametrize("k, num_devices", [(1, 1), (8, 1), (8, 4)])
def test_autotune_grid_and_winner_match_reference(monkeypatch, k,
                                                  num_devices):
    jc, tc = _pair("road_like")
    algos = ("parcrs", "csb", "bcohch", "mergeb") + (
        ("sellcs",) if k > 1 else ())
    ja, jr = _tune(JA, jc, monkeypatch, algorithms=algos, k=k,
                   num_devices=num_devices)
    ta, tr = _tune(TA, tc, monkeypatch, algorithms=algos, k=k,
                   num_devices=num_devices)
    assert [(r.algorithm, r.beta, r.k_tile) for r in tr] == \
        [(r.algorithm, r.beta, r.k_tile) for r in jr]
    assert all(r.convert_s == 1.0 for r in tr)
    assert (ta.algorithm, ta.beta) == (ja.algorithm, ja.beta)
    for a, b in zip(jr, tr):
        assert b.total_s == pytest.approx(a.total_s, rel=1e-9)
        assert (b.schedule, b.mesh_shape, b.num_chunks) == (
            a.schedule, a.mesh_shape, a.num_chunks)
    with pytest.raises(NotImplementedError, match="tpu_model"):
        TA.autotune(tc, tpu_model=True)


def test_autotune_measures_every_candidate_on_the_cpu():
    _, tc = _pair("uniform")
    best, res = TA.autotune(tc, num_spmvs=20, reps=1,
                            algorithms=("parcrs", "csb", "sellcs"),
                            betas=[64, 128], k=4)
    assert [(r.algorithm, r.beta) for r in res] == [
        ("parcrs", None), ("csb", 64), ("csb", 128), ("sellcs", None)]
    assert best.total_s == min(r.total_s for r in res)
    assert all(r.convert_s > 0 and r.spmv_s > 0 and r.tpu_model_s is None
               for r in res)
    assert best.total_s == pytest.approx(best.convert_s + 20 * best.spmv_s)


def test_pagerank_plans_agree_with_each_other_and_the_reference():
    res = pagerank.main(["--device", "cpu", "--scale", "8", "--iters",
                         "20", "--impl", "plain"])
    assert res["plans"] == ("merge", "sellcs")
    assert res["stats"].swaps == 1 and res["stats"].multiplies == 40
    # the reference's power iteration on the same graph
    rows, cols, _, shape = TM.rmat(scale=8, edge_factor=12, seed=0)
    n = shape[0]
    deg = np.bincount(cols, minlength=n).astype(np.float32)
    jc = J.to_coo(rows, cols, 1.0 / np.maximum(deg[cols], 1.0), shape)
    r = jnp.full((n,), 1.0 / n, jnp.float32)
    for _ in range(20):
        r = pagerank.DAMP * J.spmv(jc, r) + (1 - pagerank.DAMP) / n
        r = r / jnp.sum(r)
    for got in (res["r1"], res["r2"]):
        assert np.abs(got.numpy() - np.asarray(r)).max() <= 1e-5


@pytest.mark.parametrize("pkg", sorted(NOT_PORTED))
def test_package_exports_hold_the_reference(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == NOT_PORTED[pkg]
    for name in port.__all__:
        assert hasattr(port, name), name
