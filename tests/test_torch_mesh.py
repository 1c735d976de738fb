"""repro_torch multi-device schedules against the JAX package: the mesh
helpers, the partitioners (arrays equal to the reference's), K8's plain
version against the Pallas body in interpret mode, both multiplies against
the reference's 8-device answers and its oracle, the three gather modes,
``core.distributed``, the operator's mesh plans and ``shrink_to``, and
``serve --devices``.

The reference's mesh needs ``XLA_FLAGS=--xla_force_host_platform_
device_count=8`` before JAX starts, so one module-scoped subprocess
computes every 8-device answer this file needs (``impl="ref"``, small
shapes) into an ``.npz``; the port runs in-process on a mesh that names
the CPU eight times. Partition arrays need no mesh and are compared
in-process.

Tolerances: partition arrays, col maps and chunk plans equal exactly; a
multiply within ``rtol = 1e-5, atol = 1e-4`` of the reference (its own
distributed tests' rule: float32 sums over shards and spans in another
order); K8's plain version within ``rtol = atol = 1e-5`` of the Pallas
body; the gather modes bitwise equal to each other.
"""
import functools
import json
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
from repro import spmm as JS
from repro.core import distributed as JCD
from repro.spmm import distributed as JD
from repro.spmm import kernels as JK
from repro.spmm import reference as JR

from repro_torch.core import PlanSpec, to_coo
from repro_torch.core import distributed as TCD
from repro_torch.data import matrices as TM
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import serve as tserve
from repro_torch.spmm import SparseOperator, coo_to_sellcs
from repro_torch.spmm import distributed as TD
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import reference as TR
from torch_threads import two_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-4
C, SIGMA = 16, 64


def _sym_trip():
    """A == A^T by construction."""
    r = np.random.default_rng(7)
    m, half = 300, 1500
    rows, cols = r.integers(0, m, half), r.integers(0, m, half)
    vals = r.standard_normal(half).astype(np.float32)
    return (np.concatenate([rows, cols]).astype(np.int32),
            np.concatenate([cols, rows]).astype(np.int32),
            np.concatenate([vals, vals]), (m, m))


TRIPS = {
    "uniform": lambda: TM.uniform(500, 430, 4000, 0),
    "mawi_like": lambda: TM.mawi_like(400, 400, 3000, 0.4, 1),
    "road_like": lambda: TM.mesh2d(24, 1),
    "sym": _sym_trip,
}

# (matrix, mesh, k, op, compact_x, schedule, num_chunks): the 8-device
# reference answers; each is held against every port variant of it (a
# reference mesh multiply costs seconds to compile on the CPU, so the
# wider grid is held against the reference's single-device oracle)
CASES = [
    ("uniform", (8, 1), 1, "N", False, "row", 1),
    ("mawi_like", (8, 1), 64, "N", True, "merge", 3),
    ("uniform", (4, 2), 8, "T", True, "merge", 1),
    ("sym", (8, 1), 8, "N", False, "row", 1),
]

# operator plans whose reference labels the subprocess records
OP_SPECS = [
    dict(num_devices=8, mesh_shape=(8, 1), schedule="merge", num_chunks=2,
         compact_x=True, gather="fused"),
    dict(num_devices=8, mesh_shape=(4, 2), schedule="row",
         compact_x=False),
]


def _key(case):
    return "/".join(str(v) for v in case)


def _x(rows, k, seed):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(
        np.float32)


def _case_x(case):
    name, _, k, op, *_ = case
    m, n = TRIPS[name]()[3]
    return _x(m if op == "T" else n, k, k + (op == "T"))


SUB = textwrap.dedent("""
    import sys, json
    import numpy as np, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    import test_torch_mesh as T
    from repro.core import to_coo, PlanSpec
    from repro.launch.mesh import make_spmm_mesh
    from repro.spmm import (coo_to_sellcs, partition_sellcs_nnz,
                            partition_sellcs_rows, spmm_merge_distributed,
                            spmm_row_distributed, SparseOperator)
    out = {{}}
    for case in T.CASES:
        name, mesh_shape, k, op, cx, sched, nc = case
        coo = to_coo(*T.TRIPS[name]())
        sc = coo_to_sellcs(coo, c=T.C, sigma=T.SIGMA,
                           structure="symmetric" if name == "sym"
                           else "general")
        mesh = make_spmm_mesh(mesh_shape)
        x = jnp.asarray(T._case_x(case))
        if sched == "row":
            part = partition_sellcs_rows(sc, mesh_shape[0], compact_x=cx)
            y = spmm_row_distributed(part, x, mesh, op=op)
        else:
            part = partition_sellcs_nnz(sc, mesh_shape[0], num_chunks=nc,
                                        compact_x=cx)
            y = spmm_merge_distributed(part, x, mesh, num_chunks=nc, op=op)
        out[T._key(case)] = np.asarray(y)
    coo = to_coo(*T.TRIPS["uniform"]())
    labels = []
    for i, kw in enumerate(T.OP_SPECS):
        op = SparseOperator.from_coo(coo, PlanSpec(**kw), impl="ref")
        labels.append(op.plan.label)
        if i == 0:
            import jax
            labels.append(op.shrink_to(jax.devices()[:6]).label)
    np.savez({path!r}, **out)
    json.dump(labels, open({path!r} + ".json", "w"))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               + os.environ.get("XLA_FLAGS", ""))
    out = subprocess.run(
        [sys.executable, "-c", SUB.format(tests=str(ROOT / "tests"),
                                          path=path)],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path)), json.load(open(path + ".json"))


def _mesh(shape):
    return TMESH.make_spmm_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


@functools.lru_cache(maxsize=None)
def _pair(name):
    trip = TRIPS[name]()
    sym = "symmetric" if name == "sym" else "general"
    jc, tc = J.to_coo(*trip), TM.as_coo(trip, device=CPU)
    return (jc, tc, JS.coo_to_sellcs(jc, c=C, sigma=SIGMA, structure=sym),
            coo_to_sellcs(tc, c=C, sigma=SIGMA, structure=sym))


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.cpu().numpy()
    assert a.shape == b.shape and np.array_equal(a, b), what


def _same_partition(a, b):
    for f in ("data", "cols", "slice_of", "slice_offset", "row_counts",
              "col_map", "n_touched"):
        fa, fb = getattr(a, f), getattr(b, f)
        assert (fa is None) == (fb is None), f
        if fa is not None:
            _eq(fa, fb, f)
    assert (a.shape, a.chunk, a.num_slices, a.slices_per_shard, a.nnz,
            a.schedule) == (b.shape, b.chunk, b.num_slices,
                            b.slices_per_shard, b.nnz, b.schedule)
    assert (a.chunk_plan is None) == (b.chunk_plan is None)
    if a.chunk_plan is not None:
        assert a.chunk_plan[0] == b.chunk_plan[0]
        assert len(a.chunk_plan[1]) == len(b.chunk_plan[1])
        for sa, sb in zip(a.chunk_plan[1], b.chunk_plan[1]):
            assert (sa.slice_start, sa.num_slices) == (sb.slice_start,
                                                       sb.num_slices)
            for f in ("data", "cols", "slice_of", "sub", "col_map",
                      "n_touched"):
                fa, fb = getattr(sa, f), getattr(sb, f)
                assert (fa is None) == (fb is None), f
                if fa is not None:
                    _eq(fa, fb, f"span {f}")
        for i in (2, 3):
            assert (a.chunk_plan[i] is None) == (b.chunk_plan[i] is None)
            if a.chunk_plan[i] is not None:
                _eq(a.chunk_plan[i], b.chunk_plan[i], f"plan map {i}")


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------
def test_mesh_helpers_repeat_devices_and_refuse_missing_cards():
    mesh = TMESH.make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.devices[3, 1] == torch.device(CPU)
    assert TMESH.make_spmm_mesh((8, 1), devices=[CPU] * 8).axis_names == (
        "data",)
    assert TMESH.dp_axes(mesh) == ("data",)
    assert TMESH.model_axis(mesh) == "model"
    assert TMESH.parse_mesh_shape("4,2") == TMESH.parse_mesh_shape("4x2") \
        == (4, 2)
    with pytest.raises(SystemExit):
        TMESH.parse_mesh_shape("4")
    with pytest.raises(ValueError, match="needs 8 devices"):
        TMESH.make_mesh((8,), ("data",), devices=[CPU] * 3)
    need = 1 + (torch.cuda.device_count() if torch.cuda.is_available()
                else 0)
    with pytest.raises(ValueError, match=f"needs {need} devices"):
        TMESH.make_mesh((need,), ("data",))


# ---------------------------------------------------------------------------
# partitions: arrays equal to the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rows", "rows_cx", "nnz", "nnz_cx",
                                  "nnz3", "nnz3_cx"])
@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("name", ["uniform", "mawi_like", "road_like"])
def test_partition_arrays_equal_reference(name, P, kind):
    _, _, jsc, tsc = _pair(name)
    cx = kind.endswith("_cx")
    if kind.startswith("rows"):
        a = JD.partition_sellcs_rows(jsc, P, compact_x=cx)
        b = TD.partition_sellcs_rows(tsc, P, compact_x=cx)
    else:
        nc = 3 if kind.startswith("nnz3") else 1
        a = JD.partition_sellcs_nnz(jsc, P, num_chunks=nc, compact_x=cx)
        b = TD.partition_sellcs_nnz(tsc, P, num_chunks=nc, compact_x=cx)
    _same_partition(a, b)
    # the port's storage adds its slice pointers and slot lengths
    extra = sum(t.numel() * 4 for t in (b.slice_ptr, b.depth_ptr,
                                        b.row_len) if t is not None)
    if b.chunk_plan is not None:
        extra += sum(t.numel() * 4 for sp in b.chunk_plan[1]
                     for t in (sp.slice_ptr, sp.depth_ptr, sp.local_of))
    assert b.storage_bytes() == a.storage_bytes() + extra
    # each shard's real prefix is what its kernels see
    counts = b.row_counts.tolist()
    for p, sh in enumerate(b.shards):
        assert sh.width_rows == counts[p]
        assert int(sh.slice_ptr[-1]) == counts[p]


@pytest.mark.parametrize("cx", [False, True])
@pytest.mark.parametrize("name", ["uniform", "mawi_like", "road_like"])
def test_rechunk_and_redeal_equal_reference(name, cx):
    _, tc, jsc, tsc = _pair(name)
    a = JD.partition_sellcs_nnz(jsc, 8, compact_x=cx)
    b = TD.partition_sellcs_nnz(tsc, 8, compact_x=cx)
    _same_partition(JD.rechunk_sellcs(a, 3), TD.rechunk_sellcs(b, 3))
    assert TD.rechunk_sellcs(b, 1).chunk_plan is None
    _same_partition(JD.redeal_sellcs(a, 5, num_chunks=2),
                    TD.redeal_sellcs(b, 5, num_chunks=2))
    a = JD.partition_sellcs_rows(jsc, 8, compact_x=cx)
    b = TD.partition_sellcs_rows(tsc, 8, compact_x=cx)
    red = TD.redeal_sellcs(b, 3)
    _same_partition(JD.redeal_sellcs(a, 3), red)
    X = torch.from_numpy(_x(tc.shape[1], 4, 2))
    np.testing.assert_allclose(
        TD.spmm_row_distributed(red, X, _mesh((3, 1)), impl="plain").numpy(),
        np.asarray(JS.spmm_coo(J.to_coo(*TRIPS[name]()),
                               jnp.asarray(X.numpy()))),
        rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# K8: the plain version against the Pallas body (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 5])
def test_fused_kernel_plain_matches_pallas_interpret(k):
    _, _, jsc, tsc = _pair("uniform")
    jp = JD.partition_sellcs_rows(jsc, 2, compact_x=True)
    tp = TD.partition_sellcs_rows(tsc, 2, compact_x=True)
    n = tsc.shape[1]
    X = _x(n, k, 3)
    np_ = -(-n // JK.LANE) * JK.LANE
    x_pad = jnp.zeros((np_, k), jnp.float32).at[:n].set(X)
    ln = int(tp.row_counts[0])
    want = np.asarray(JK.sellcs_slots(
        jp.data[0], jp.cols[0], jp.slice_of[0], x_pad,
        num_slices=jp.slices_per_shard, chunk=C, k_tile=k, interpret=True,
        col_map=jp.col_map[0]))
    sh = tp.shards[0]
    got = TK.sellcs_slots_plain(sh.data, sh.cols, sh.slice_ptr,
                                torch.from_numpy(X), num_slices=sh.num_slices,
                                chunk=C, col_map=sh.col_map)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors is the plain version, and fused equals the
    # up-front slab bitwise
    assert torch.equal(TK.sellcs_slots(
        sh.data, sh.cols, sh.slice_ptr, torch.from_numpy(X),
        num_slices=sh.num_slices, chunk=C, col_map=sh.col_map), got)
    slab = torch.from_numpy(X).index_select(0, sh.col_map)
    assert torch.equal(TK.sellcs_slots_plain(
        sh.data, sh.cols, sh.slice_ptr, slab, num_slices=sh.num_slices,
        chunk=C), got)
    # the oracle with col_map, and the chunk entry on a merge span
    np.testing.assert_allclose(TR.sellcs_slots_ref(
        tp.data[0, :ln], tp.cols[0, :ln], tp.slice_of[0, :ln],
        torch.from_numpy(X), num_slices=tp.slices_per_shard, chunk=C,
        col_map=tp.col_map[0]).numpy(), want, rtol=1e-5, atol=1e-5)
    jm = JD.partition_sellcs_nnz(jsc, 2, num_chunks=3, compact_x=True)
    tm = TD.partition_sellcs_nnz(tsc, 2, num_chunks=3, compact_x=True)
    jspan, tspan = jm.chunk_plan[1][1], tm.chunk_plan[1][1]
    want = np.asarray(JK.sellcs_slots_chunk(
        jspan.data[1], jspan.cols[1], jspan.slice_of[1], x_pad,
        slice_start=jspan.slice_start, num_slices=jspan.num_slices, chunk=C,
        k_tile=k, interpret=True, col_map=jm.chunk_plan[2][1]))
    ln = tspan.shards[1].width_rows
    got = TK.sellcs_slots_chunk(
        tspan.data[1, :ln], tspan.cols[1, :ln], tspan.slice_of[1, :ln],
        torch.from_numpy(X), slice_start=tspan.slice_start,
        num_slices=tspan.num_slices, chunk=C, col_map=tm.chunk_plan[2][1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TR.sellcs_slots_chunk_ref(
        tspan.data[1], tspan.cols[1], tspan.slice_of[1], torch.from_numpy(X),
        slice_start=tspan.slice_start, num_slices=tspan.num_slices, chunk=C,
        col_map=tm.chunk_plan[2][1]).numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the multiplies
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _oracle(name, k, op):
    """The reference's single-device answer on the grid's X (shared by
    the grid's schedules and meshes)."""
    jc, tc, _, _ = _pair(name)
    X = _x(tc.shape[0] if op == "T" else tc.shape[1], k, k)
    return np.asarray(JR.spmm_ref(jc, jnp.asarray(X), op=op))


def _multiply(part, X, mesh, sched, nc, op, impl, gather):
    if sched == "row":
        return TD.spmm_row_distributed(part, X, mesh, impl=impl, op=op,
                                       gather=gather)
    return TD.spmm_merge_distributed(part, X, mesh, impl=impl, op=op,
                                     num_chunks=nc, gather=gather)


def _partition(sc, sched, pd, nc, cx):
    if sched == "row":
        return TD.partition_sellcs_rows(sc, pd, compact_x=cx)
    return TD.partition_sellcs_nnz(sc, pd, num_chunks=nc, compact_x=cx)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_multiply_matches_8_device_reference(ref, case):
    name, mesh_shape, k, op, cx, sched, nc = case
    _, _, _, tsc = _pair(name)
    part = _partition(tsc, sched, mesh_shape[0], nc, cx)
    mesh = _mesh(mesh_shape)
    X = torch.from_numpy(_case_x(case))
    want = ref[0][_key(case)]
    gathers = (None, "overlap", "fused") if cx else (None,)
    for impl in ("plain", "ref"):
        outs = [_multiply(part, X, mesh, sched, nc, op, impl, g)
                for g in gathers]
        for y in outs:
            assert y.shape == want.shape
            np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
        for y in outs[1:]:
            assert torch.equal(y, outs[0])


@pytest.mark.parametrize("op", ["N", "T"])
@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("sched", ["row", "merge1", "merge3"])
@pytest.mark.parametrize("name", ["uniform", "mawi_like", "road_like"])
def test_multiply_grid_matches_reference_oracle(name, sched, mesh_shape, op):
    jc, tc, _, tsc = _pair(name)
    nc = int(sched[-1]) if sched.startswith("merge") else 1
    sched = sched.rstrip("13")
    mesh = _mesh(mesh_shape)
    for cx in (False, True):
        part = _partition(tsc, sched, mesh_shape[0], nc, cx)
        for k in (1, 8, 64):
            X = _x(tc.shape[0] if op == "T" else tc.shape[1], k, k)
            want = _oracle(name, k, op)
            outs = [_multiply(part, torch.from_numpy(X), mesh, sched, nc,
                              op, "plain", g)
                    for g in ((None, "overlap", "fused") if cx else (None,))]
            for y in outs:
                np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                                           atol=ATOL)
            for y in outs[1:]:
                assert torch.equal(y, outs[0])
    # SpMV rides along as the 1-D k = 1 case
    x = torch.from_numpy(_x(tc.shape[0] if op == "T" else tc.shape[1], 1,
                            5)[:, 0])
    y = _multiply(part, x, mesh, sched, nc, op, "ref", None)
    assert y.ndim == 1


def test_multiply_validates_its_arguments():
    _, _, _, tsc = _pair("uniform")
    row = TD.partition_sellcs_rows(tsc, 4)
    X = torch.zeros(tsc.shape[1], 2)
    with pytest.raises(ValueError, match="partition_sellcs_nnz"):
        TD.spmm_merge_distributed(row, X, _mesh((4, 1)))
    with pytest.raises(ValueError, match="mesh axis"):
        TD.spmm_row_distributed(row, X, _mesh((8, 1)))
    with pytest.raises(ValueError, match="compact_x"):
        TD.spmm_row_distributed(row, X, _mesh((4, 1)), gather="fused")
    with pytest.raises(ValueError, match="compact_x=True"):
        TD.spmm_row_distributed(row, X, _mesh((4, 1)), compact_x=True)
    with pytest.raises(ValueError, match="CUDA"):
        TD.spmm_row_distributed(row, X, _mesh((4, 1)), impl="kernel")
    with pytest.raises(ValueError, match="X rows"):
        TD.spmm_row_distributed(row, X[:-1], _mesh((4, 1)))
    with pytest.raises(ValueError, match="num_chunks"):
        TD.partition_sellcs_nnz(tsc, 4, num_chunks=0)
    with pytest.raises(ValueError, match="devices"):
        TD.partition_sellcs_rows(tsc, 4, devices=[CPU] * 3)


def test_empty_matrix_and_more_shards_than_slices():
    trip = TM.uniform(40, 30, 100, 3)
    tc = TM.as_coo(trip, device=CPU)
    sc = coo_to_sellcs(tc, c=16, sigma=16)           # 3 slices, 8 shards
    want = np.asarray(JS.spmm_coo(J.to_coo(*trip),
                                  jnp.asarray(_x(30, 3, 1))))
    X = torch.from_numpy(_x(30, 3, 1))
    for cx in (False, True):
        for sched, nc in (("row", 1), ("merge", 5)):
            part = _partition(sc, sched, 8, nc, cx)
            y = _multiply(part, X, _mesh((8, 1)), sched, nc, "N", "plain",
                          None)
            np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                                       atol=ATOL)
    empty = coo_to_sellcs(to_coo(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), (40, 30),
                                 device=CPU), c=16, sigma=16)
    y = TD.spmm_merge_distributed(TD.partition_sellcs_nnz(empty, 4), X,
                                  _mesh((4, 1)))
    assert y.shape == (40, 3) and not y.any()


# ---------------------------------------------------------------------------
# core.distributed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [3, 8])
@pytest.mark.parametrize("name", ["uniform", "mawi_like"])
def test_core_distributed_spmv_matches_reference(name, P):
    jc, tc, _, _ = _pair(name)
    for part_j, part_t in ((JCD.partition_rows, TCD.partition_rows),
                           (JCD.partition_nnz, TCD.partition_nnz)):
        a, b = part_j(jc, P), part_t(tc, P)
        for f in ("rows", "cols", "vals", "row_offset"):
            _eq(getattr(a, f), getattr(b, f), f)
        assert a.rows_per_shard == b.rows_per_shard
    mesh = _mesh((P, 1))
    for k in (None, 4):
        X = _x(tc.shape[1], k or 1, 6)
        X = X[:, 0] if k is None else X
        want = np.asarray(JS.spmm_coo(jc, jnp.asarray(X)))
        for y in (TCD.spmv_row_distributed(TCD.partition_rows(tc, P),
                                           torch.from_numpy(X), mesh),
                  TCD.spmv_merge_distributed(TCD.partition_nnz(tc, P),
                                             torch.from_numpy(X), mesh)):
            np.testing.assert_allclose(y.numpy(), want, rtol=RTOL,
                                       atol=ATOL)


# ---------------------------------------------------------------------------
# the operator and serve
# ---------------------------------------------------------------------------
def test_operator_mesh_plans_and_shrink_to_match_reference(ref):
    labels = ref[1]
    trip = TRIPS["uniform"]()
    jc, tc = J.to_coo(*trip), TM.as_coo(trip, device=CPU)
    op = SparseOperator.from_coo(tc, PlanSpec(**OP_SPECS[0]), impl="plain",
                                 devices=[CPU] * 8)
    assert op.plan.label == labels[0]
    X = torch.from_numpy(_x(tc.shape[1], 4, 11))
    want = np.asarray(JS.spmm_coo(jc, jnp.asarray(X.numpy())))
    np.testing.assert_allclose(op.matmul(X).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    Xt = _x(tc.shape[0], 3, 12)
    np.testing.assert_allclose(
        op.T.matmul(torch.from_numpy(Xt)).numpy(),
        np.asarray(JR.spmm_ref(jc, jnp.asarray(Xt), op="T")),
        rtol=RTOL, atol=ATOL)
    assert op.stats.partition_builds == 1 and op.stats.sellcs_builds == 1
    # a chunks-only swap re-bakes the span plan, no repartition
    op.swap(PlanSpec(**{**OP_SPECS[0], "num_chunks": 4}))
    assert op.stats.partition_builds == 1 and op.plan.matrix.chunk_plan[0] \
        == 4
    op.swap(PlanSpec(**OP_SPECS[0]))
    shrunk = op.shrink_to([CPU] * 6)
    assert shrunk.label == labels[1] and op.spec.num_devices == 6
    np.testing.assert_allclose(op.matmul(X).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert op.stats.partition_builds == 2 and op.stats.sellcs_builds == 1
    op2 = SparseOperator.from_coo(tc, PlanSpec(**OP_SPECS[1]), impl="ref",
                                  devices=[CPU] * 8)
    assert op2.plan.label == labels[2]
    assert op2.plan.labels()["mesh"] == "4x2"
    np.testing.assert_allclose(op2.matmul(X).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="cannot run on a mesh"):
        op2.realize(PlanSpec(num_devices=8, algorithm="csb"))


def test_serve_devices_on_a_cpu_mesh(tmp_path):
    path = str(tmp_path / "m.json")
    res = tserve.main(["--mode", "spmv", "--matrix", "mawi_like", "--scale",
                       "0.01", "--requests", "12", "--max-batch", "4",
                       "--reps", "1", "--devices", "4", "--mesh-devices",
                       "cpu,cpu,cpu,cpu", "--device", "cpu", "--impl",
                       "plain", "--compact-x", "on", "--gather", "fused",
                       "--metrics", path])
    op = res["op"]
    assert op.spec.num_devices == 4 and op.spec.gather == "fused"
    assert op.plan.label.startswith("sellcs+") and "/gx=fused" in \
        op.plan.label
    jc = J.to_coo(*TM.test_suite(0.01)["mawi_like"].make())
    X = torch.stack(res["xs"], dim=1)
    want = np.asarray(JS.spmm_coo(jc, jnp.asarray(X.numpy())))
    got = torch.stack([res["answers"][r] for r in res["rids"]], dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    doc = json.load(open(path))
    names = {h["name"] for h in doc["histograms"] if h["count"]}
    assert {"spmm/mesh", "spmm/kernel", "spmm/fixup"} <= names
    assert doc["labels"]["devices"] in (4, "4")
    with pytest.raises(SystemExit, match="cannot be served on a mesh"):
        tserve.main(["--mode", "spmv", "--matrix", "mawi_like", "--scale",
                     "0.01", "--devices", "2", "--mesh-devices", "cpu,cpu",
                     "--algorithm", "csb", "--device", "cpu"])
    with pytest.raises(SystemExit, match="mesh-devices"):
        tserve.main(["--mode", "spmv", "--matrix", "mawi_like", "--scale",
                     "0.01", "--mesh", "2,2", "--mesh-devices", "cpu,cpu",
                     "--device", "cpu"])
