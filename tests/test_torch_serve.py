"""repro_torch serving: SparseOperator, RequestBatcher and serve --mode spmv
against the JAX package, plus the port's import isolation.

Inputs come from the same seeds on both sides; answers agree to float32
tolerance ``rtol = atol = 2e-4`` (the reference serve's own check).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro.data import matrices as JM
from repro.spmm import RequestBatcher as JBatcher
from repro.spmm import SparseOperator as JOperator

from repro_torch import obs as TO
from repro_torch.core import PlanSpec
from repro_torch.data import matrices as TM
from repro_torch.launch import serve as tserve
from repro_torch.spmm import (RequestBatcher, SparseOperator, batch_spmv,
                              spmm_coo)

RTOL, ATOL = 2e-4, 2e-4
CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _coos(name="mawi_like", scale=0.01):
    trip = TM.test_suite(scale)[name].make()
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


@pytest.mark.parametrize("impl", ["plain", "ref"])
def test_operator_matches_reference_across_swap(impl):
    jc, tc = _coos()
    X = np.random.default_rng(3).standard_normal(
        (tc.shape[1], 8)).astype(np.float32)
    jop = JOperator.from_coo(jc, J.PlanSpec(num_devices=1,
                                            algorithm="merge"), impl="ref")
    want = np.asarray(jop.matmul(jnp.asarray(X)))
    op = SparseOperator.from_coo(tc, PlanSpec(num_devices=1,
                                              algorithm="merge"), impl=impl)
    Xt = torch.from_numpy(X)
    np.testing.assert_allclose(op.matmul(Xt).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert op.plan.spec.algorithm == "merge" and op.plan.impl == impl
    op.swap(PlanSpec(num_devices=1, algorithm="sellcs"))
    assert op.plan.spec.algorithm == "sellcs"
    np.testing.assert_allclose((op @ Xt).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert op.matmul(Xt[:, 0]).ndim == 1
    assert (op.stats.multiplies, op.stats.calls, op.stats.swaps) == \
        (8 + 8 + 1, 3, 1)
    assert op.stats.sellcs_builds == 1
    # the roofline price of a flush is positive and grows with k
    assert 0 < op.plan.model_s(1) < op.plan.model_s(32)
    with pytest.raises(TypeError):
        op.swap("sellcs")


@pytest.mark.parametrize("impl", ["plain", "ref"])
def test_operator_builds_merge_plan_once_at_realize(impl):
    """A merge-path CSR plan's merge plan is part of its conversion: built
    by ``realize`` (inside ``build_s``), reused by every multiply. The
    oracle path never needs one."""
    from repro_torch.kernels.merge_spmv import default_num_spans
    _, tc = _coos()
    op = SparseOperator.from_coo(tc, PlanSpec(num_devices=1,
                                              algorithm="merge"), impl=impl)
    csr = op.plan.matrix
    if impl == "ref":
        assert csr.plans == {}
        return
    spans = default_num_spans(tc.shape[0], tc.nnz)
    plan = csr.plans[spans]
    assert op.plan.build_s > 0
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (tc.shape[1], 4)).astype(np.float32))
    op.matmul(X)
    op.matmul(X[:, 0])
    assert list(csr.plans) == [spans] and csr.plans[spans] is plan


def test_operator_unported_surfaces_raise_naming_their_slice():
    """The multi-device surfaces are ported: a mesh plan is realized over
    the devices it is given, and without enough devices (or on a
    single-device plan, for ``shrink_to``) it raises saying what is
    missing instead of running somewhere else."""
    _, tc = _coos()
    op = SparseOperator.from_coo(tc, PlanSpec(num_devices=1,
                                              algorithm="sellcs"),
                                 impl="plain")
    need = 1 + max(torch.cuda.device_count()
                   if torch.cuda.is_available() else 0, 1)
    with pytest.raises(ValueError, match=f"needs {need} devices"):
        op.realize(PlanSpec(num_devices=need))
    with pytest.raises(ValueError, match="distributed plan"):
        op.shrink_to([0])
    mesh_op = SparseOperator.from_coo(tc, PlanSpec(num_devices=2),
                                      impl="plain", devices=[CPU] * 2)
    assert mesh_op.spec.num_devices == 2
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tc.shape[1]).astype(np.float32))
    np.testing.assert_allclose(mesh_op.matmul(x).numpy(),
                               spmm_coo(tc, x).numpy(), rtol=RTOL, atol=ATOL)


def test_batcher_matches_reference_batcher():
    jc, tc = _coos("hhh_like")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(tc.shape[1]).astype(np.float32)
          for _ in range(11)]
    jb = JBatcher(J.coo_to_csr(jc), max_batch=4, impl="ref")
    jr = [jb.submit(jnp.asarray(x)) for x in xs]
    jout = jb.drain()
    from repro_torch.core import coo_to_csr
    tb = RequestBatcher(coo_to_csr(tc), max_batch=4, impl="plain")
    tr = [tb.submit(torch.from_numpy(x)) for x in xs]
    tout = tb.drain()
    assert tr == jr and tb.flushes == jb.flushes == 3
    for a, b in zip(jr, tr):
        np.testing.assert_allclose(tout[b].numpy(), np.asarray(jout[a]),
                                   rtol=RTOL, atol=ATOL)
    # batch_spmv promotes the batch dtype and answers in input order
    ys = batch_spmv(tc, [torch.from_numpy(xs[0]),
                         torch.from_numpy(xs[1]).double()], impl="ref")
    assert ys[0].dtype == torch.float64
    np.testing.assert_allclose(ys[1].numpy(), spmm_coo(
        tc, torch.from_numpy(xs[1]).double()).numpy(), rtol=1e-12)
    with pytest.raises(ValueError):
        tb.submit(torch.zeros(3))


def _counters(doc):
    return {c["name"]: c["value"] for c in doc["counters"]}


def test_serve_migrate_force_matches_reference_serve(tmp_path):
    """The port's serve (CPU, the kernels' plain versions, forced
    migration) answers every request like the reference's operator and
    batcher on the same seeded requests, and records the same migration
    decision inputs as the reference serve."""
    args = ["--mode", "spmv", "--matrix", "mawi_like", "--scale", "0.01",
            "--requests", "16", "--max-batch", "4", "--reps", "1",
            "--migrate", "force"]
    tpath, jpath = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    res = tserve.main(args + ["--device", "cpu", "--impl", "plain",
                              "--metrics", tpath])
    from repro.launch import serve as jserve
    jserve.main(args + ["--impl", "ref", "--metrics", jpath])
    tdoc, jdoc = json.load(open(tpath)), json.load(open(jpath))
    # the reference's answers for the same requests (serve draws them from
    # default_rng(seed) exactly like this)
    jc = J.to_coo(*JM.test_suite(0.01)["mawi_like"].make())
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(jc.shape[1]).astype(np.float32)
          for _ in range(16)]
    jop = JOperator.from_coo(jc, J.PlanSpec(num_devices=1,
                                            algorithm="merge"), impl="ref")
    jb = JBatcher(jop, max_batch=4, spmm_fn=lambda _m, X: jop.matmul(X))
    jrids = [jb.submit(jnp.asarray(x)) for x in xs]
    jout = jb.drain()
    for i, (jr, tr) in enumerate(zip(jrids, res["rids"])):
        np.testing.assert_array_equal(res["xs"][i].numpy(), xs[i])
        np.testing.assert_allclose(res["answers"][tr].numpy(),
                                   np.asarray(jout[jr]), rtol=RTOL,
                                   atol=ATOL)
    tc, jcn = _counters(tdoc), _counters(jdoc)
    for name in ("serve/multiplies_total", "serve/plan_swaps",
                 "batcher/flushes", "batcher/served"):
        assert tc[name] == jcn[name], name
    assert tc["serve/plan_swaps"] == 1
    tg = {g["name"]: g["value"] for g in tdoc["gauges"]}
    assert tg["serve/convert_s"] > 0
    assert math.isfinite(tg["serve/breakeven_estimate"])
    assert tdoc["schema"] == jdoc["schema"] == "repro.obs/v1"
    assert tdoc["labels"]["migrate"] == "force"
    assert tdoc["labels"]["backend"] == "cpu"
    assert len(tdoc["residuals"]) == len(jdoc["residuals"]) == 4
    assert not TO.enabled()


def test_serve_pinned_sellcs_and_flag_checks():
    res = tserve.main(["--mode", "spmv", "--matrix", "hhh_like", "--scale",
                       "0.01", "--requests", "9", "--max-batch", "4",
                       "--reps", "1",
                       "--algorithm", "sellcs", "--device", "cpu",
                       "--impl", "plain"])
    assert res["op"].plan.label == "sellcs"
    assert len(res["answers"]) == 9
    with pytest.raises(SystemExit):
        tserve.main(["--mode", "spmv", "--matrix", "hhh_like", "--scale",
                     "0.01", "--migrate", "auto", "--algorithm", "csb",
                     "--device", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(["--mode", "spmv", "--matrix", "nope", "--device",
                     "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tserve.main(["--mode", "spmv", "--matrix", "hhh_like",
                         "--scale", "0.01"])


def test_import_isolation_no_jax_no_repro():
    """Every repro_torch module imports with jax and repro blocked."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert {"repro_torch.launch.mesh", "repro_torch.spmm.distributed",
            "repro_torch.core.distributed", "repro_torch.configs.base",
            "repro_torch.configs.granite_moe_1b_a400m",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.model",
            "repro_torch.models.accounting",
            "repro_torch.kernels.moe_group_matmul"} <= set(mods)
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "repro"):
            sys.modules[name] = None
        import importlib
        for m in {mods!r}:
            importlib.import_module(m)
        leaked = [k for k in sys.modules
                  if (k == "jax" or k.startswith("jax.") or k == "repro"
                      or k.startswith("repro.")) and sys.modules[k]]
        assert not leaked, leaked
        print("ISOLATED", len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
    # the smoke script too: it imports nothing of jax or repro
    src = (ROOT / "chip_smoke.py").read_text()
    for bad in ("import jax", "from jax", "import repro\n", "from repro ",
                "from repro."):
        assert bad not in src
