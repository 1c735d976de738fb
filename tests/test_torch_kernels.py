"""repro_torch kernels: plain versions vs the JAX Pallas kernels, dispatch.

Each plain PyTorch version (what a kernel wrapper runs for CPU tensors) is
held against the JAX package's Pallas function run in interpret mode on
the same arrays, as ``tests/test_spmm.py`` runs it. Tolerance: float32,
``rtol = atol = 2e-4`` (the reference suite's), because the port sums in
another order (the reference's one-hot matmuls vs segmented sums and
carries). SELL-C-σ slot sums keep the reference's per-slot order.

Tests of the CUDA kernels themselves need the card; they live in
``tests/test_torch_cuda.py``, which imports no JAX so that it also runs on
a machine with a card and no JAX.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro import spmm as JS
from repro.kernels import ops as JOPS
from repro.kernels.merge_spmv import merge_plan as j_merge_plan
from repro.spmm import kernels as JK

from repro_torch import interop
from repro_torch.core import coo_to_csr, spmv as t_spmv
from repro_torch.data import matrices as TM
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import ops as TOPS
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import (coo_to_sellcs, csr_spmm, sellcs_spmm, spmm,
                              spmm_coo)
from torch_threads import two_threads  # noqa: F401 (autouse)

RTOL, ATOL = 2e-4, 2e-4
CPU = "cpu"


def _pair(name="mawi_like", scale=0.01):
    trip = TM.test_suite(scale)[name].make()
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


def _x(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


# --------------------------------------------------------------------------
# K1: SELL-C-σ
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("name", ["mawi_like", "livejournal_like"])
def test_sellcs_plain_matches_pallas_interpret(name, k):
    jc, tc = _pair(name)
    js = JS.coo_to_sellcs(jc, c=32, sigma=64)
    ts = coo_to_sellcs(tc, c=32, sigma=64)
    X = _x(jc.shape[1], k, k)
    want = np.asarray(JK.sellcs_spmm(js, jnp.asarray(X), interpret=True))
    got = sellcs_spmm(ts, torch.from_numpy(X), plain=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 8])
def test_sellcs_slots_plain_matches_raw_pallas_slots(k):
    """The slot-space kernel alone (no unpermute), on the reference's own
    arrays carried across with interop."""
    jc, _ = _pair("mawi_like")
    js = JS.coo_to_sellcs(jc, c=16, sigma=32)
    d = {f: np.asarray(getattr(js, f)) for f in (
        "data", "cols", "slice_ptr", "slice_of", "row_perm", "row_len")}
    d.update(shape=js.shape, chunk=js.chunk, sigma=js.sigma, nnz=js.nnz)
    ts = interop.sellcs_from_arrays(d, device=CPU)
    X = _x(jc.shape[1], k, 3)
    np_ = -(-jc.shape[1] // 128) * 128
    x_pad = np.zeros((np_, k), np.float32)
    x_pad[:jc.shape[1]] = X
    want = np.asarray(JK.sellcs_slots(
        js.data, js.cols, js.slice_of, jnp.asarray(x_pad),
        num_slices=js.num_slices, chunk=js.chunk, k_tile=k,
        interpret=True))
    got = TK.sellcs_slots_plain(ts.data, ts.cols, ts.slice_ptr,
                                torch.from_numpy(X),
                                num_slices=ts.num_slices, chunk=ts.chunk)
    np.testing.assert_allclose(got.numpy(), want[:, :k], rtol=RTOL,
                               atol=ATOL)
    # the wrapper takes the plain version for CPU tensors, no launch counted
    before = TK.sellcs_slots.launches
    wrapped = TK.sellcs_slots(ts.data, ts.cols, ts.slice_ptr,
                              torch.from_numpy(X), num_slices=ts.num_slices,
                              chunk=ts.chunk)
    assert torch.equal(wrapped, got) and TK.sellcs_slots.launches == before


# --------------------------------------------------------------------------
# K2 / K4 and the carry step: merge-path CSR
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_csr_spmm_plain_matches_pallas_interpret(name, k):
    jc, tc = _pair(name)
    X = _x(jc.shape[1], k, k + 1)
    want = np.asarray(JK.csr_spmm(J.coo_to_csr(jc), jnp.asarray(X),
                                  interpret=True))
    got = csr_spmm(coo_to_csr(tc), torch.from_numpy(X), plain=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_spans", [8, 64, 400])
def test_merge_spmv_plain_matches_pallas_interpret(num_spans):
    """K4's function on the reference plan (carried across by interop,
    span lengths recovered) and on the port's own plan."""
    jc, tc = _pair("mawi_like")
    jr = J.coo_to_csr(jc)
    x = _x(jc.shape[1], 1, 5)[:, 0]
    jp = j_merge_plan(jr, num_spans)
    want = np.asarray(JOPS.merge_spmv(jr, jnp.asarray(x), plan=jp,
                                      interpret=True))
    csr = coo_to_csr(tc)
    xt = torch.from_numpy(x)
    got = TOPS.merge_spmv(csr, xt, num_spans=num_spans, plain=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    carried = interop.merge_plan_from_arrays(
        {"cols": np.asarray(jp.cols), "vals": np.asarray(jp.vals),
         "seg": np.asarray(jp.seg), "row_starts": np.asarray(jp.row_starts),
         "r_width": jp.r_width}, device=CPU)
    got2 = TOPS.merge_spmv(csr, xt, plan=carried, plain=True)
    np.testing.assert_allclose(got2.numpy(), want, rtol=RTOL, atol=ATOL)
    # CPU tensors: the wrappers run the plain versions
    got3 = TOPS.merge_spmv(csr, xt, num_spans=num_spans)
    np.testing.assert_allclose(got3.numpy(), want, rtol=RTOL, atol=ATOL)


def test_merge_carries_cover_a_row_across_many_spans():
    """A dense row crossing dozens of spans: every span but the first and
    last holds only that row, and the carry step must add all of them."""
    m = n = 300
    rows = np.concatenate([np.full(n, 7), np.arange(m)])
    cols = np.concatenate([np.arange(n), np.arange(m)])
    vals = np.random.default_rng(0).standard_normal(rows.size).astype(
        np.float32)
    jc = J.to_coo(rows, cols, vals, (m, n))
    tc = TM.as_coo((rows, cols, vals, (m, n)), device=CPU)
    csr = coo_to_csr(tc)
    plan = TMS.merge_plan(csr, 60)
    x = torch.from_numpy(_x(n, 1, 9)[:, 0])
    y, cr, cv = TMS.merge_partials_plain(plan, x[:, None], m)
    assert int((cr == 7).sum()) >= 20            # the row rides many carries
    full = TMS.carry_out_fixup_plain(y, cr, cv)[:, 0]
    want = np.asarray(J.spmv(jc, jnp.asarray(x.numpy()), impl="ref"))
    np.testing.assert_allclose(full.numpy(), want, rtol=RTOL, atol=ATOL)
    # padding (seg == 0, val == 0) after a span's real items never reopens
    # local row 0: a span ending mid-row keeps its rows intact
    assert int(plan.span_len.min()) < plan.depth


def test_merge_plan_never_has_partials_buffer():
    _, tc = _pair("hhh_like")
    csr = coo_to_csr(tc)
    plan = TMS.cached_merge_plan(csr)
    x = torch.from_numpy(_x(tc.shape[1], 4, 2))
    y, cr, cv = TK._merge_spmm_partials(plan, x, tc.shape[0])
    # outputs are Y-sized plus [2P, k] carries, never [P, R, k]
    assert y.shape == (tc.shape[0], 4)
    assert cr.shape == (2 * plan.num_spans,)
    assert cv.shape == (2 * plan.num_spans, 4)


# --------------------------------------------------------------------------
# dispatch, dtype rule, k-tiles
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["coo", "csr", "sellcs"])
def test_spmm_dispatch_and_dtype_rule(fmt):
    jc, tc = _pair("mawi_like")
    mat = {"coo": tc, "csr": coo_to_csr(tc),
           "sellcs": coo_to_sellcs(tc, c=32)}[fmt]
    X = _x(tc.shape[1], 8, 4)
    want = np.asarray(JS.spmm_ref(jc, jnp.asarray(X)))
    Xt = torch.from_numpy(X)
    ref = spmm(mat, Xt, impl="ref")
    np.testing.assert_allclose(ref.numpy(), want, rtol=RTOL, atol=ATOL)
    assert spmm(mat, Xt).dtype == torch.float32            # auto -> ref
    # references promote; kernel paths return float32
    X64 = Xt.double()
    assert spmm(mat, X64, impl="ref").dtype == torch.float64
    if fmt != "coo":
        assert spmm(mat, X64, impl="plain").dtype == torch.float32
        np.testing.assert_allclose(spmm(mat, Xt, impl="plain").numpy(),
                                   want, rtol=RTOL, atol=ATOL)
        y1 = spmm(mat, Xt[:, 0], impl="plain")
        assert y1.shape == (tc.shape[0],)
        with pytest.raises(ValueError, match="CUDA"):
            spmm(mat, Xt, impl="kernel")
    else:
        with pytest.raises(TypeError):
            spmm(mat, Xt, impl="plain")
    # op='T': K3's plain version on SELL-C-σ; no transpose kernel for the
    # other formats, as under the reference's impl='pallas'
    Xm = torch.from_numpy(_x(tc.shape[0], 8, 5))
    if fmt == "sellcs":
        want_t = np.asarray(JS.spmm_ref(jc, jnp.asarray(Xm.numpy()),
                                        op="T"))
        np.testing.assert_allclose(spmm(mat, Xm, impl="plain",
                                        op="T").numpy(), want_t,
                                   rtol=RTOL, atol=ATOL)
    else:
        with pytest.raises(TypeError, match="transpose"):
            spmm(mat, Xm, impl="plain", op="T")
    with pytest.raises(ValueError):
        spmm(mat, Xt, impl="pallas")


@pytest.mark.parametrize("fmt", ["coo", "csr", "sellcs"])
def test_spmv_dispatch_matches_reference(fmt):
    jc, tc = _pair("hhh_like")
    jmat = {"coo": jc, "csr": J.coo_to_csr(jc),
            "sellcs": JS.coo_to_sellcs(jc)}[fmt]
    tmat = {"coo": tc, "csr": coo_to_csr(tc),
            "sellcs": coo_to_sellcs(tc)}[fmt]
    x = _x(tc.shape[1], 1, 6)[:, 0]
    want = np.asarray(J.spmv(jmat, jnp.asarray(x), impl="ref"))
    for impl in (("ref", "plain") if fmt != "coo" else ("ref", "auto")):
        got = t_spmv(tmat, torch.from_numpy(x), impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_choose_k_tile_contract():
    for k in (1, 7, 32, 300):
        kt = TK.choose_k_tile((10 ** 4, 10 ** 4), k, nnz=10 ** 5)
        assert 1 <= kt <= k
    assert TK.choose_k_tile((100, 100), 1) == 1
    # SpMM on a memory-bound card never crosses the f32 ridge at serve k
    assert TK.choose_k_tile((2 ** 20, 2 ** 20), 32, nnz=12_582_840) == 32
    # the multiplies accept the reference's k_tile and cover all k in one
    # launch whatever it says: same answer
    _, tc = _pair("mawi_like")
    X = torch.from_numpy(_x(tc.shape[1], 9, 8))
    ref = spmm_coo(tc, X)
    for mat, fn in ((coo_to_sellcs(tc, c=32), sellcs_spmm),
                    (coo_to_csr(tc), csr_spmm)):
        got = fn(mat, X, k_tile=4, plain=True)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                                   atol=ATOL)
