"""repro_torch transpose path against the JAX package: K3's plain version,
the transpose oracles, one-triangle symmetric storage, the operator's
``rmatmul``/``.T`` surface, ``sparse_matmul`` as a
``torch.autograd.Function`` and the GMRES example.

The same seeded numpy inputs go through ``repro`` (its Pallas kernels in
interpret mode, as ``tests/test_spmm_transpose.py`` runs them on the CPU)
and through the port's plain versions. Tolerance: float32,
``rtol = atol = 2e-4`` (the reference suite's): the port adds the
transposed products with ``index_add_`` where the reference contracts a
one-hot matrix, so the sums run in another order. Storage arrays must be
equal exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import core as J
from repro import spmm as JS
from repro.core.formats import COO as JCOO
from repro.spmm import kernels as JK
from repro.spmm import reference as JR

from repro_torch import interop
from repro_torch.core import PlanSpec, coo_to_csr
from repro_torch.core.formats import COO
from repro_torch.data import matrices as TM
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import reference as TR
from repro_torch.spmm import (SparseOperator, TransposedOperator,
                              coo_to_sellcs, sellcs_spmm, sparse_matmul,
                              spmm, spmm_coo_t, spmm_ref, spmm_sellcs_t)
from torch_threads import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-4, 2e-4
CPU = "cpu"
SELL_FIELDS = ("data", "cols", "slice_ptr", "slice_of", "row_perm",
               "row_len")


def _pair(name="mawi_like", scale=0.01):
    trip = TM.test_suite(scale)[name].make()
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


def _x(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _sym_trip(m, nnz_half, seed):
    """A == A^T by construction: half the entries mirrored."""
    r = np.random.default_rng(seed)
    rows = r.integers(0, m, nnz_half)
    cols = r.integers(0, m, nnz_half)
    vals = r.standard_normal(nnz_half).astype(np.float32)
    return (np.concatenate([rows, cols]).astype(np.int32),
            np.concatenate([cols, rows]).astype(np.int32),
            np.concatenate([vals, vals]), (m, m))


def _sym_pair(m=300, nnz_half=3000, seed=0):
    trip = _sym_trip(m, nnz_half, seed)
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# K3: the transpose pass
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("name", ["mawi_like", "livejournal_like"])
def test_sellcs_t_plain_matches_pallas_interpret(name, k):
    jc, tc = _pair(name)
    js = JS.coo_to_sellcs(jc, c=32, sigma=64)
    ts = coo_to_sellcs(tc, c=32, sigma=64)
    X = _x(jc.shape[0], k, k)
    want = np.asarray(JK.sellcs_spmm(js, jnp.asarray(X), interpret=True,
                                     op="T"))
    got = sellcs_spmm(ts, torch.from_numpy(X), plain=True, op="T")
    assert got.dtype == torch.float32 and got.shape == (jc.shape[1], k)
    _close(got, want)
    # the wrapper takes the plain version for CPU tensors, no launch counted
    before = TK.sellcs_slots_t.launches
    _close(sellcs_spmm(ts, torch.from_numpy(X), op="T"), want)
    assert TK.sellcs_slots_t.launches == before


def test_sellcs_slots_t_plain_matches_raw_pallas_slots():
    """The slot-space kernel alone, on the reference's own arrays carried
    across with interop and the reference's own slot-ordered X."""
    jc, _ = _pair("mawi_like")
    js = JS.coo_to_sellcs(jc, c=16, sigma=32)
    d = {f: np.asarray(getattr(js, f)) for f in SELL_FIELDS}
    d.update(shape=js.shape, chunk=js.chunk, sigma=js.sigma, nnz=js.nnz)
    ts = interop.sellcs_from_arrays(d, device=CPU)
    X = _x(jc.shape[0], 4, 3)
    xs = np.asarray(JR.sellcs_slot_x(js.row_perm, jnp.asarray(X),
                                     jc.shape[0]))
    want = np.asarray(JK.sellcs_slots_t(
        js.data, js.cols, js.slice_of, jnp.asarray(xs), n_out=jc.shape[1],
        chunk=js.chunk, k_tile=4, interpret=True))
    txs = TR.sellcs_slot_x(ts.row_perm, torch.from_numpy(X), jc.shape[0])
    np.testing.assert_array_equal(txs.numpy(), xs)
    got = TK.sellcs_slots_t_plain(ts.data, ts.cols, ts.slice_of,
                                  ts.slice_ptr, ts.row_len, txs,
                                  n_out=jc.shape[1], chunk=ts.chunk)
    _close(got, want)
    # padding entries are skipped, which changes no sum
    _close(TR.sellcs_slots_t_ref(ts.data, ts.cols, ts.slice_of, txs,
                                 n_out=jc.shape[1], chunk=ts.chunk), got)


def test_transpose_degenerates():
    """nnz == 0 answers f32 zeros [n, k]; 1-D x rides along as k = 1;
    explicit-zero entries stay harmless through the scatter."""
    z = np.zeros(0, np.int32)
    empty = TM.as_coo((z, z, np.zeros(0, np.float32), (64, 48)), device=CPU)
    se = coo_to_sellcs(empty, c=16, sigma=16)
    y = sellcs_spmm(se, torch.ones((64, 4)), plain=True, op="T")
    assert y.shape == (48, 4) and y.dtype == torch.float32
    assert float(y.abs().max()) == 0
    rows = np.array([0, 0, 0] + list(range(1, 16)), np.int32)
    cols = np.array([0, 2, 3] + [r % 4 for r in range(1, 16)], np.int32)
    vals = np.array([1.0, 0.0, 0.0] + [float(r) for r in range(1, 16)],
                    np.float32)
    tc = TM.as_coo((rows, cols, vals, (16, 4)), device=CPU)
    jc = J.to_coo(rows, cols, vals, (16, 4))
    sc = coo_to_sellcs(tc, c=4, sigma=16)
    x = _x(16, 1, 0)[:, 0]
    want = np.asarray(JR.spmm_coo_t(jc, jnp.asarray(x)))
    got = spmm(sc, torch.from_numpy(x), impl="plain", op="T")
    assert got.shape == (4,)
    _close(got, want)


# --------------------------------------------------------------------------
# oracles
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mawi_like", "hhh_like"])
def test_transpose_oracles_match_reference(name):
    jc, tc = _pair(name)
    js = JS.coo_to_sellcs(jc, c=32, sigma=64)
    ts = coo_to_sellcs(tc, c=32, sigma=64)
    X = _x(jc.shape[0], 8, 1)
    Xt, Xj = torch.from_numpy(X), jnp.asarray(X)
    want = np.asarray(JR.spmm_coo_t(jc, Xj))
    for got in (spmm_coo_t(tc, Xt), spmm_sellcs_t(ts, Xt),
                spmm_ref(ts, Xt, op="T"), spmm_ref(tc, Xt, op="T")):
        _close(got, want)
    _close(spmm_sellcs_t(ts, Xt), JR.spmm_sellcs_t(js, Xj))
    # references promote; 1-D rides along
    assert spmm_ref(ts, Xt.double(), op="T").dtype == torch.float64
    assert spmm_ref(tc, Xt[:, 0], op="T").shape == (jc.shape[1],)
    with pytest.raises(TypeError, match="transpose"):
        spmm_ref(coo_to_csr(tc), Xt, op="T")
    with pytest.raises(TypeError, match="transpose"):
        JR.spmm_ref(J.coo_to_csr(jc), Xj, op="T")


# --------------------------------------------------------------------------
# one-triangle symmetric storage
# --------------------------------------------------------------------------
@pytest.mark.parametrize("c, sigma", [(32, 64), (8, 8)])
def test_symmetric_sellcs_arrays_equal_reference(c, sigma):
    jc, tc = _sym_pair()
    js = JS.coo_to_sellcs(jc, c=c, sigma=sigma, structure="symmetric")
    ts = coo_to_sellcs(tc, c=c, sigma=sigma, structure="symmetric")
    for f in SELL_FIELDS + ("diag",):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (ts.nnz, ts.structure, ts.storage_bytes()) == \
        (js.nnz, "symmetric", js.storage_bytes())
    # the mirrored round trip is dense-equivalent to the full matrix
    np.testing.assert_allclose(ts.to_coo().todense().numpy(),
                               tc.todense().numpy(), rtol=1e-6, atol=1e-6)
    X = _x(300, 5, 2)
    want = np.asarray(JS.spmm_ref(jc, jnp.asarray(X)))
    for op in ("N", "T"):
        _close(sellcs_spmm(ts, torch.from_numpy(X), plain=True, op=op),
               want)
        _close(spmm_ref(ts, torch.from_numpy(X), op=op), want)
    _close(sellcs_spmm(ts, torch.from_numpy(X), plain=True),
           JK.sellcs_spmm(js, jnp.asarray(X), interpret=True))


def test_symmetric_requires_symmetric_input():
    """Asymmetric input raises at conversion and at the operator surface;
    rectangular input raises on shape alone; symmetric structure is a
    SELL-C-σ capability only."""
    r = np.random.default_rng(2)
    rows = r.integers(0, 50, 300).astype(np.int32)
    cols = r.integers(0, 50, 300).astype(np.int32)
    vals = r.standard_normal(300).astype(np.float32)
    asym = TM.as_coo((rows, cols, vals, (50, 50)), device=CPU)
    with pytest.raises(ValueError, match="A == A"):
        coo_to_sellcs(asym, structure="symmetric")
    with pytest.raises(ValueError):
        SparseOperator(asym, PlanSpec(num_devices=1, algorithm="sellcs",
                                      structure="symmetric"), impl="plain")
    rect = COO(torch.from_numpy(rows), torch.from_numpy(cols),
               torch.from_numpy(vals), (50, 60))
    with pytest.raises(ValueError, match="square"):
        coo_to_sellcs(rect, structure="symmetric")
    _, sym = _sym_pair(50, 200, 3)
    with pytest.raises(ValueError, match="SELL"):
        SparseOperator(sym, PlanSpec(num_devices=1, algorithm="parcrs",
                                     structure="symmetric"), impl="plain")
    with pytest.raises(ValueError):
        coo_to_sellcs(sym, structure="banded")


def test_symmetric_storage_at_most_55_percent():
    """One-triangle storage reports <= 55 % of the general format's
    ``storage_bytes`` on a dense-ish symmetric matrix (the reference's
    own acceptance case, its duplicates left unsummed), and multiplies
    like it."""
    ar, ac, av, shape = _sym_trip(512, 40000, 0)
    jc = JCOO(jnp.asarray(ar), jnp.asarray(ac), jnp.asarray(av), shape)
    tc = COO(torch.from_numpy(ar), torch.from_numpy(ac),
             torch.from_numpy(av), shape)
    gen = coo_to_sellcs(tc, c=32)
    sym = coo_to_sellcs(tc, c=32, structure="symmetric")
    ratio = sym.storage_bytes() / gen.storage_bytes()
    assert ratio <= 0.55, ratio
    assert ratio == pytest.approx(
        JS.coo_to_sellcs(jc, c=32, structure="symmetric").storage_bytes()
        / JS.coo_to_sellcs(jc, c=32).storage_bytes())
    X = torch.from_numpy(_x(512, 4, 1))
    _close(sellcs_spmm(sym, X, plain=True), sellcs_spmm(gen, X, plain=True))


def test_symmetric_sellcs_carried_by_interop_multiplies_identically():
    jc, _ = _sym_pair(200, 1500, 5)
    js = JS.coo_to_sellcs(jc, c=16, sigma=32, structure="symmetric")
    d = {f: np.asarray(getattr(js, f)) for f in SELL_FIELDS + ("diag",)}
    d.update(shape=js.shape, chunk=js.chunk, sigma=js.sigma, nnz=js.nnz,
             structure=js.structure)
    ts = interop.sellcs_from_arrays(d, device=CPU)
    assert ts.structure == "symmetric" and ts.diag is not None
    X = _x(200, 6, 4)
    for op in ("N", "T"):
        want = np.asarray(JK.sellcs_spmm(js, jnp.asarray(X),
                                         interpret=True, op=op))
        _close(sellcs_spmm(ts, torch.from_numpy(X), plain=True, op=op),
               want)
        _close(spmm(ts, torch.from_numpy(X), impl="ref", op=op),
               JS.spmm_ref(js, jnp.asarray(X), op=op))


# --------------------------------------------------------------------------
# the operator surface
# --------------------------------------------------------------------------
@pytest.mark.parametrize("algo, impl", [("sellcs", "plain"),
                                        ("sellcs", "ref"),
                                        ("merge", "plain")])
def test_operator_rmatmul_and_T_share_one_plan(algo, impl):
    jc, tc = _pair("livejournal_like")
    X = _x(jc.shape[0], 8, 9)
    jop = JS.SparseOperator.from_coo(jc, J.PlanSpec(num_devices=1,
                                                    algorithm=algo),
                                     impl="ref")
    want = np.asarray(jop.rmatmul(jnp.asarray(X)))
    op = SparseOperator.from_coo(tc, PlanSpec(num_devices=1,
                                              algorithm=algo), impl=impl)
    builds = op.stats.sellcs_builds
    Xt = torch.from_numpy(X)
    _close(op.rmatmul(Xt), want)
    tv = op.T
    assert isinstance(tv, TransposedOperator)
    assert tv.T is op and tv.shape == (jc.shape[1], jc.shape[0])
    assert tv.plan is op.plan
    _close(tv @ Xt, want)
    _close(tv.rmatmul(torch.from_numpy(_x(jc.shape[1], 3, 1))),
           op.matmul(torch.from_numpy(_x(jc.shape[1], 3, 1))))
    assert op.rmatmul(Xt[:, 0]).shape == (jc.shape[1],)
    assert op.stats.sellcs_builds == builds          # no rebuild for T
    assert (op.stats.multiplies, op.stats.calls) == (8 + 8 + 3 + 3 + 1, 5)


def test_operator_symmetric_structure_end_to_end():
    jc, tc = _sym_pair(256, 2000, 6)
    op = SparseOperator(tc, PlanSpec(num_devices=1, algorithm="sellcs",
                                     structure="symmetric"), impl="plain")
    assert op.plan.spec.structure == "symmetric"
    assert op.plan.matrix.structure == "symmetric"
    X = _x(256, 8, 7)
    want = np.asarray(JS.spmm_ref(jc, jnp.asarray(X)))
    _close(op.matmul(torch.from_numpy(X)), want)
    _close(op.rmatmul(torch.from_numpy(X)), want)
    assert op.stats.sellcs_builds == 1


def test_sparse_matmul_gradient_matches_jax_grad():
    """The differentiable surface: torch autograd through
    ``sparse_matmul`` (forward matmul, backward rmatmul over the one plan)
    equals ``jax.grad`` of the same loss through the reference's
    ``custom_vjp``."""
    r = np.random.default_rng(7)
    m, n, nnz = 60, 40, 500
    rows = r.integers(0, m, nnz).astype(np.int32)
    cols = r.integers(0, n, nnz).astype(np.int32)
    vals = r.standard_normal(nnz).astype(np.float32)
    X = r.standard_normal((n, 4)).astype(np.float32)
    T = r.standard_normal((m, 4)).astype(np.float32)
    jop = JS.SparseOperator(J.to_coo(rows, cols, vals, (m, n)),
                            J.PlanSpec(num_devices=1, algorithm="sellcs"),
                            impl="ref", k_hint=4)
    want = np.asarray(jax.grad(lambda x: jnp.sum(
        (JS.sparse_matmul(jop, x) - jnp.asarray(T)) ** 2))(jnp.asarray(X)))
    op = SparseOperator(TM.as_coo((rows, cols, vals, (m, n)), device=CPU),
                        PlanSpec(num_devices=1, algorithm="sellcs"),
                        impl="plain", k_hint=4)
    xt = torch.from_numpy(X).requires_grad_(True)
    loss = torch.sum((sparse_matmul(op, xt) - torch.from_numpy(T)) ** 2)
    (g,) = torch.autograd.grad(loss, xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-3)
    assert op.stats.multiplies == 8              # one forward, one backward
    # 1-D x, and the transpose view as the operator
    v = torch.from_numpy(T[:, 0]).requires_grad_(True)
    (gv,) = torch.autograd.grad(sparse_matmul(op.T, v).sum(), v)
    _close(gv, op.matmul(torch.ones(n)))


def test_rmatmul_without_transpose_plan_raises_re_realize():
    _, tc = _pair("hhh_like")
    op = SparseOperator.from_coo(tc, PlanSpec(num_devices=1,
                                              algorithm="sellcs"),
                                 impl="plain")
    op2 = SparseOperator(tc, op.plan._replace(multiply_t=None),
                         impl="plain")
    with pytest.raises(ValueError, match="re-realize"):
        op2.rmatmul(torch.zeros(tc.shape[0]))


def test_spmm_dispatcher_op_validation():
    """Bad op rejected; op='T' on a kernel-less format raises on the
    kernel paths, as ``impl='pallas'`` does in the reference; the oracle
    covers COO and "auto" takes it for a format without a kernel."""
    r = np.random.default_rng(8)
    trip = (r.integers(0, 30, 200).astype(np.int32),
            r.integers(0, 20, 200).astype(np.int32),
            r.standard_normal(200).astype(np.float32), (30, 20))
    tc, jc = TM.as_coo(trip, device=CPU), J.to_coo(*trip)
    X = _x(30, 4, 0)
    Xt = torch.from_numpy(X)
    with pytest.raises(ValueError, match="op"):
        spmm(tc, Xt, op="X")
    with pytest.raises(ValueError, match="op"):
        sellcs_spmm(coo_to_sellcs(tc, c=8), Xt, op="X")
    for mat in (tc, coo_to_csr(tc)):
        with pytest.raises(TypeError, match="transpose"):
            spmm(mat, Xt, impl="plain", op="T")
    with pytest.raises(TypeError, match="transpose"):
        JS.spmm(jc, jnp.asarray(X), impl="pallas_interpret", op="T")
    want = np.asarray(JR.spmm_coo_t(jc, jnp.asarray(X)))
    _close(spmm(tc, Xt, op="T"), want)
    sc = coo_to_sellcs(tc, c=8, sigma=16)
    _close(spmm(sc, Xt, impl="plain", op="T"), want)
    assert spmm(sc, Xt.double(), impl="plain", op="T").dtype == \
        torch.float32


# --------------------------------------------------------------------------
# the GMRES example
# --------------------------------------------------------------------------
def test_gmres_example_forward_and_adjoint_on_cpu(capsys):
    from repro_torch.examples import gmres
    res = gmres.main(["--device", "cpu", "--impl", "plain", "--scale", "10",
                      "--algorithm", "sellcs"])
    assert res["residual"] < 1e-5 and res["residual_t"] < 1e-5
    assert res["plan"] == "sellcs" and res["stats"].sellcs_builds == 1
    assert "gmres OK" in capsys.readouterr().out
