"""The port's multi-tenant fleet against the JAX package on the CPU: the
COO fingerprint, ``RequestBatcher``'s bounded queues (``QueueFull``),
the ``FleetBatcher`` scheduler, the ``Fleet`` plan cache and its
evictions, ``SparseOperator(feedback=, cache=)``, the device-loss re-deal
on a mesh of eight CPU positions, ``largest_feasible_mesh``,
``StragglerMonitor`` and ``serve --mode fleet``.

The same seeded triplets go through both packages. The reference's mesh
needs XLA's host device-count flag before JAX starts, so the mesh cases
run on the port only and are held against the reference's single-device
oracle (``repro.spmm.spmm_coo``) and its partitioner, which needs no mesh.

Tolerance: answers within ``rtol = atol = 2e-4`` of the reference's
oracle (the reference suite's serve rule); partitions, fingerprints and
scheduler decisions equal exactly.
"""
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro import obs as JO
from repro import spmm as JS
from repro.runtime import elastic as JEL
from repro.runtime import fault_tolerance as JFT
from repro.spmm import distributed as JD

from repro_torch import obs as TO
from repro_torch import runtime as TRT
from repro_torch import spmm as TS
from repro_torch.core import PlanSpec
from repro_torch.data import matrices as TM
from repro_torch.launch import serve as tserve
from repro_torch.spmm import distributed as TD
from torch_threads import two_threads  # noqa: F401 (autouse)

RTOL = ATOL = 2e-4
CPU = "cpu"


def _trip(m=300, n=300, nnz=2400, seed=0):
    return TM.uniform(m, n, nnz, seed)


def _pair(trip):
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


def _x(n, k=None, seed=0):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _want(jc, X):
    return np.asarray(JS.spmm_coo(jc, jnp.asarray(X)))


# ---------------------------------------------------------------------------
# the plan-cache key
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["uniform", "mawi_like", "permuted"])
def test_fingerprint_equal_on_both_packages(case):
    trip = (TM.mawi_like(200, 200, 1500, 0.4, 1) if case == "mawi_like"
            else _trip())
    if case == "permuted":
        rows, cols, vals, shape = trip
        p = np.random.default_rng(5).permutation(len(rows))
        ref = JS.coo_fingerprint(J.to_coo(*trip))
        trip = (rows[p], cols[p], vals[p], shape)
    else:
        ref = None
    jc, tc = _pair(trip)
    fp = TS.coo_fingerprint(tc)
    assert fp == JS.coo_fingerprint(jc)
    if ref is not None:
        assert fp == ref            # a permuted stream hashes the same


# ---------------------------------------------------------------------------
# bounded queues and the flush scheduler
# ---------------------------------------------------------------------------
class _Op:
    """A matmul-only stand-in over one package's oracle."""

    def __init__(self, coo, fn):
        self.coo, self.fn, self.shape = coo, fn, coo.shape

    def matmul(self, X):
        return self.fn(self.coo, X)


def test_queue_full_under_raise_matches_reference():
    jc, tc = _pair(_trip(50, 50, 200))
    x = _x(50)
    got = []
    for pkg, obs, coo, arr in ((JS, JO, jc, jnp.asarray(x)),
                               (TS, TO, tc, torch.from_numpy(x))):
        reg = obs.install(obs.MetricRegistry())
        try:
            b = pkg.RequestBatcher(coo, max_batch=8, max_pending=3,
                                   name="a")
            for _ in range(3):
                b.submit(arr)
            with pytest.raises(pkg.QueueFull) as exc:
                b.submit(arr)
            e = exc.value
            got.append((e.tenant, e.pending, e.max_pending, str(e),
                        b.rejected,
                        reg.counter("batcher/rejected",
                                    {"tenant": "a"}).value,
                        reg.gauge("batcher/pending", {"tenant": "a"}).value,
                        len(b.flush()), b.pending))
        finally:
            obs.uninstall()
    assert got[0] == got[1]
    with pytest.raises(ValueError):
        TS.RequestBatcher(tc, max_pending=0)
    with pytest.raises(ValueError):
        TS.RequestBatcher(tc, overflow="drop")


def test_block_overflow_waits_for_a_flush():
    tc = TM.as_coo(_trip(50, 50, 200), device=CPU)
    x = torch.ones(50)
    b = TS.RequestBatcher(tc, max_batch=2, max_pending=2, overflow="block")
    b.submit(x)
    b.submit(x)
    unblocked = threading.Event()

    def blocked_submit():
        b.submit(x)
        unblocked.set()

    t = threading.Thread(target=blocked_submit)
    t.start()
    assert not unblocked.wait(0.2), "submit must wait while full"
    served = b.flush()
    assert unblocked.wait(5.0), "a flush must wake the waiting submitter"
    t.join(5.0)
    assert not t.is_alive()
    assert len(served) == 2 and b.pending == 1 and b.rejected == 0


def _script(pkg, coos, to_arr, fn):
    """One submit/flush script under a fake clock: the scheduler's picks
    (next_tenant at set times, then a drain) and every answer."""
    t = [0.0]
    fb = pkg.FleetBatcher(clock=lambda: t[0])
    for i, name in enumerate(("a", "b", "c")):
        fb.add_tenant(name, _Op(coos[name], fn), max_batch=2 + i,
                      slo_s=0.05 * (i + 1))
    sent, picks = {}, [fb.next_tenant()]
    for j in range(24):
        name = ("a", "b", "c")[(j * 7) % 3 if j % 4 else 1]
        t[0] = 0.01 * j
        sent[(name, fb.submit(name, to_arr(_x(40, seed=j))))] = j
        if j % 5 == 4:
            picks.append(fb.next_tenant(now=t[0] + 0.002))
    # a later pick, every lane past its budget
    t[0] = 1.0
    picks.append(fb.next_tenant(now=1.0))
    t[0] = 1.5
    while fb.total_pending:
        tenant, res = fb.flush_next()
        picks.append((tenant, sorted(res)))
        t[0] += 0.003
    lanes = [(fb.lane(n).served, fb.lane(n).flushes,
              fb.lane(n).slo_violations) for n in fb.tenants()]
    return picks, lanes, sent


def test_fleet_batcher_order_and_drain_match_reference():
    trips = {n: _trip(40, 40, 200, seed=i)
             for i, n in enumerate(("a", "b", "c"))}
    jcs = {n: J.to_coo(*t) for n, t in trips.items()}
    tcs = {n: TM.as_coo(t, device=CPU) for n, t in trips.items()}
    jp, jl, _ = _script(JS, jcs, jnp.asarray, JS.spmm_coo)
    tp, tl, sent = _script(TS, tcs, torch.from_numpy, TS.spmm_coo)
    assert tp == jp and tl == jl
    # nothing dropped: every ticket answered once
    served = [(p[0], rid) for p in tp if isinstance(p, tuple)
              for rid in p[1]]
    assert len(served) == len(sent)
    assert set(served) == set(sent)
    # the tie-break: the older oldest arrival wins on both
    t = [0.0]
    for pkg, arr in ((JS, jnp.asarray), (TS, torch.from_numpy)):
        fb = pkg.FleetBatcher(clock=lambda: t[0])
        fb.add_tenant("young", _Op(jcs["a"] if pkg is JS else tcs["a"],
                                   pkg.spmm_coo), max_batch=2, slo_s=1.0)
        fb.add_tenant("old", _Op(jcs["a"] if pkg is JS else tcs["a"],
                                 pkg.spmm_coo), max_batch=2, slo_s=1.0)
        t[0] = 0.0
        fb.submit("old", arr(_x(40)))
        t[0] = 0.5
        fb.submit("young", arr(_x(40)))
        assert fb.next_tenant(now=1.0) == "old"
        with pytest.raises(ValueError):
            fb.add_tenant("zero", None, slo_s=0.0)


# ---------------------------------------------------------------------------
# the plan cache, evictions, feedback= and cache=
# ---------------------------------------------------------------------------
def _fleet_events(pkg, to_coo):
    """Hits, misses and victims of one registration script."""
    fleet = pkg.Fleet(impl="ref")
    a = fleet.register("t0", to_coo(_trip(seed=1)))
    b = fleet.register("t1", to_coo(_trip(seed=1)))
    fleet.register("t2", to_coo(_trip(seed=2)))
    fleet.register("t3", to_coo(_trip(seed=1)), k_hint=8)
    out = [b.plan is a.plan, fleet.stats.plan_cache_hits,
           fleet.stats.plan_cache_misses, fleet.tenants()]
    small = pkg.Fleet(impl="ref", capacity=2)
    for i, name in enumerate(("x", "y", "z")):
        small.register(name, to_coo(_trip(seed=3 + i)))
    out += [small.tenants(), small.stats.evictions]
    roomy = pkg.Fleet(impl="ref")
    roomy.register("a", to_coo(_trip(seed=1)))
    roomy.register("b", to_coo(_trip(seed=2)))
    budget = pkg.Fleet(impl="ref", max_bytes=roomy.total_storage_bytes())
    for i, name in enumerate(("a", "b", "c")):
        budget.register(name, to_coo(_trip(seed=1 + i)))
    tiny = pkg.Fleet(impl="ref", max_bytes=1)
    tiny.register("p", to_coo(_trip(seed=1)))
    tiny.register("q", to_coo(_trip(seed=2)))
    out += [budget.tenants(), budget.stats.evictions,
            budget.stats.evicted_bytes > 0, tiny.tenants(),
            tiny.stats.evictions]
    fleet.evict("t0")
    out.append(len(fleet._artifacts))
    return out


def test_fleet_cache_hits_misses_and_victims_match_reference():
    ref = _fleet_events(JS, lambda t: J.to_coo(*t))
    port = _fleet_events(TS, lambda t: TM.as_coo(t, device=CPU))
    assert port == ref
    assert port[:3] == [True, 1, 3]
    with pytest.raises(ValueError):
        TS.Fleet(capacity=0)
    with pytest.raises(ValueError):
        TS.Fleet(max_bytes=0)


def test_operator_feedback_and_shared_cache():
    """``SparseOperator(coo, spec, feedback=ledger)`` and ``swap(spec,
    feedback=)`` reach the mesh plan's selection; a second operator over
    the same ``cache=`` pays no SELL-C-σ build and no partition."""
    jc, tc = _pair(_trip())
    spec = PlanSpec(num_devices=4)
    plain = TS.SparseOperator(tc, spec, impl="ref", devices=[CPU] * 4)
    # a ledger that says the unfed choice ran 1000x slower than modelled
    ledger = TO.ResidualLedger()
    ledger.record("serve/flush", 1.0, 1e-3, **plain.plan.labels())
    fed = TS.SparseOperator(tc, spec, impl="ref", devices=[CPU] * 4,
                            feedback=ledger)
    assert fed.spec != plain.spec
    X = _x(300, 4, 3)
    for op in (plain, fed):
        np.testing.assert_allclose(op.matmul(torch.from_numpy(X)).numpy(),
                                   _want(jc, X), rtol=RTOL, atol=ATOL)
    assert plain.swap(spec, feedback=ledger).spec == fed.spec
    shared = fed._cache
    second = TS.SparseOperator.from_coo(tc, spec, impl="ref",
                                        devices=[CPU] * 4, cache=shared,
                                        feedback=ledger)
    assert (second.stats.sellcs_builds, second.stats.partition_builds) \
        == (0, 0)
    assert second.stats.plan_cache_hits == 2
    assert second.storage_bytes() == second.plan.matrix.storage_bytes()


# ---------------------------------------------------------------------------
# device loss: 8 -> 7 positions
# ---------------------------------------------------------------------------
def test_handle_device_loss_8_to_7_on_cpu_positions():
    trip, trip2 = _trip(600, 600, 6000, 0), _trip(500, 500, 5000, 1)
    jc, tc = _pair(trip)
    jc2, tc2 = _pair(trip2)
    fleet = TS.Fleet(impl="plain", devices=[CPU] * 8)
    spec = PlanSpec(num_devices=8, schedule="row")
    op = fleet.register("t0", tc, spec, k_hint=4)
    hit = fleet.register("t1", TM.as_coo(trip, device=CPU), spec, k_hint=4)
    other = fleet.register("t2", tc2, spec, k_hint=4)
    assert hit.plan is op.plan
    assert (hit.stats.sellcs_builds, hit.stats.partition_builds) == (0, 0)
    assert op.stats.sellcs_builds == 1 and op.stats.partition_builds == 1
    X, X2 = _x(600, 4, 2), _x(500, 4, 3)
    want, want2 = _want(jc, X), _want(jc2, X2)

    def check():
        for o, x, w in ((op, X, want), (hit, X, want), (other, X2, want2)):
            np.testing.assert_allclose(o.matmul(torch.from_numpy(x)).numpy(),
                                       w, rtol=RTOL, atol=ATOL)

    check()
    assert sorted(fleet.handle_device_loss([7])) == ["t0", "t1", "t2"]
    assert fleet.failed_devices == [7] and fleet.stats.device_losses == 1
    assert hit.plan is op.plan and op.spec.num_devices == 7
    check()
    # the re-dealt shards are a fresh 7-way partition of the same stream
    sc = op.plan.single
    fresh = JD.partition_sellcs_rows(
        JS.coo_to_sellcs(jc, c=sc.chunk, sigma=sc.sigma), 7)
    got = op.plan.matrix
    for f in ("data", "cols", "slice_of", "slice_offset", "row_counts"):
        assert np.array_equal(np.asarray(getattr(fresh, f)),
                              getattr(got, f).numpy()), f
    assert (fresh.num_slices, fresh.slices_per_shard, fresh.nnz) == (
        got.num_slices, got.slices_per_shard, got.nnz)
    # a returning tenant gets the survivors' plan; a new matrix goes
    # onto the survivors only
    back = fleet.register("t3", TM.as_coo(trip, device=CPU), spec,
                          k_hint=4)
    assert back.plan is op.plan
    with pytest.raises(ValueError, match="needs 8 devices"):
        fleet.register("t4", TM.as_coo(_trip(seed=9), device=CPU), spec)


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------
def test_largest_feasible_mesh_and_straggler_monitor_match_reference():
    for args in ((8, 2), (7, 2), (7, 1), (3, 3)):
        assert TRT.largest_feasible_mesh(*args) == \
            JEL.largest_feasible_mesh(*args)
    for pkg in (TRT, JEL):
        with pytest.raises(ValueError):
            pkg.largest_feasible_mesh(1, 2)
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 2.5, 1.2, 9.0]
    mons = (TRT.StragglerMonitor(), JFT.StragglerMonitor(alpha=0.2,
                                                         threshold=1.5),
            TRT.StragglerMonitor(alpha=0.2, threshold=1.5),
            JFT.StragglerMonitor())
    flags = [[m.observe(i, dt) for i, dt in enumerate(times)] for m in mons]
    assert flags[0] == flags[3] and flags[1] == flags[2]
    assert mons[0].slow_steps == mons[3].slow_steps
    assert mons[0].ema == mons[3].ema
    fleet = TS.Fleet(impl="ref")
    assert [fleet.observe_flush("t", dt) for dt in times] == flags[0]


# ---------------------------------------------------------------------------
# serve --mode fleet
# ---------------------------------------------------------------------------
def test_serve_fleet_on_cpu_positions_with_a_loss(tmp_path):
    path = str(tmp_path / "fleet.json")
    res = tserve.main(["--mode", "fleet", "--tenants", "3", "--devices",
                       "4", "--mesh-devices", "cpu,cpu,cpu,cpu",
                       "--fail-device", "auto", "--scale", "0.02",
                       "--impl", "plain", "--requests", "24",
                       "--max-batch", "4", "--metrics", path])
    assert len(res["answers"]) == 24 and res["redeal_s"] is not None
    fleet = res["fleet"]
    assert fleet.failed_devices == [3]
    assert (fleet.stats.plan_cache_hits, fleet.stats.plan_cache_misses) \
        == (1, 2)
    # every answer against the reference's oracle of its tenant's matrix
    suite = TM.test_suite(0.02)
    for tenant, name in (("t0", "mawi_like"), ("t1", "hhh_like")):
        jc = J.to_coo(*suite[name].make())
        keys = [k for k in res["sent"] if k[0] == tenant]
        X = torch.stack([res["sent"][k] for k in keys], dim=1).numpy()
        got = torch.stack([res["answers"][k] for k in keys], dim=1)
        np.testing.assert_allclose(got.numpy(), _want(jc, X), rtol=RTOL,
                                   atol=ATOL)
        assert fleet.get(tenant).spec.num_devices == 3
    doc = json.load(open(path))
    assert doc["labels"]["mode"] == "fleet"
    assert doc["labels"]["fail_device"] in (3, "3")
    counters = {(c["name"], c["labels"].get("tenant")): c["value"]
                for c in doc["counters"]}
    assert counters[("fleet/device_losses", None)] == 1
    assert counters[("fleet/plan_cache_hits", None)] == 1
    assert counters[("fleet/plan_cache_misses", None)] == 2
    for t in ("t0", "t1", "t2"):
        assert counters[("batcher/served", t)] == 8
    names = {h["name"] for h in doc["histograms"] if h["count"]}
    assert {"fleet/flush_s", "fleet/flush_preloss_s",
            "fleet/flush_postloss_s", "fleet/redeal_s"} <= names


def test_serve_fleet_bounded_lanes_and_bad_args():
    res = tserve.main(["--mode", "fleet", "--tenants", "2", "--device",
                       "cpu", "--scale", "0.01", "--impl", "ref",
                       "--requests", "16", "--max-batch", "2",
                       "--max-pending", "3"])
    assert len(res["answers"]) == 16
    assert all(res["front"].lane(t).flushes >= 4 for t in ("t0", "t1"))
    for argv in (["--tenants", "0"], ["--fail-device", "auto"],
                 ["--devices", "2", "--mesh-devices", "cpu,cpu",
                  "--fail-device", "5"]):
        with pytest.raises(SystemExit):
            tserve.main(["--mode", "fleet", "--device", "cpu", "--scale",
                         "0.01"] + argv)
