"""repro_torch storage, conversion, planning and model parity with repro.

The same seeded numpy inputs go through the JAX package and its port; the
storage arrays must be equal exactly (same dtypes, same values), and the
pure-Python model functions must agree to float rounding.
"""
import hashlib
import importlib

import numpy as np
import pytest
import torch

from repro import core as J
from repro.data import matrices as JM
from repro.kernels.merge_spmv import merge_plan as j_merge_plan
from repro.spmm import coo_to_sellcs as j_coo_to_sellcs
from repro.spmm.operator import coo_fingerprint as j_fingerprint

from repro_torch import interop
from repro_torch.core import mergepath as TMP
from repro_torch.core import selector as TS
from repro_torch.data import matrices as TM
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.spmm import sellcs as TSC
from repro_torch.spmm.operator import coo_fingerprint as t_fingerprint
from torch_threads import two_threads  # noqa: F401 (autouse)

# core re-exports the function ``convert``, which shadows the module name
TC = importlib.import_module("repro_torch.core.convert")
JCONV = importlib.import_module("repro.core.convert")

CPU = "cpu"
SUITE = sorted(TM.test_suite(0.01))


def _np(t):
    return np.asarray(t)


def _pair(name, scale=0.01):
    """(jax COO, port COO) of one suite matrix."""
    trip = TM.test_suite(scale)[name].make()
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


@pytest.mark.parametrize("name", SUITE)
def test_generators_bit_identical(name):
    a = JM.test_suite(0.01)[name].make()
    b = TM.test_suite(0.01)[name].make()
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["mawi_like", "hhh_like", "kron_like"])
def test_coo_and_csr_arrays_equal(name):
    jc, tc = _pair(name)
    for f in ("rows", "cols", "data"):
        np.testing.assert_array_equal(_np(getattr(jc, f)),
                                      getattr(tc, f).numpy())
    assert tc.shape == jc.shape and tc.nnz == jc.nnz
    assert tc.storage_bytes() == jc.storage_bytes()
    jr, tr = J.coo_to_csr(jc), TC.coo_to_csr(tc)
    for f in ("row_ptr", "col_ind", "data"):
        np.testing.assert_array_equal(_np(getattr(jr, f)),
                                      getattr(tr, f).numpy())
    assert tr.storage_bytes() == jr.storage_bytes()
    np.testing.assert_array_equal(_np(jr.row_of_nnz()),
                                  tr.row_of_nnz().numpy())


def test_canonicalize_sums_duplicates_like_reference():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 20, 300)
    c = rng.integers(0, 30, 300)
    v = rng.standard_normal(300).astype(np.float32)
    a = JCONV.coo_canonicalize_np(r, c, v, (20, 30))
    b = TC.coo_canonicalize_np(r, c, v, (20, 30))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("c,sigma", [(8, 8), (32, 64), (128, None),
                                     (64, 10 ** 6)])
@pytest.mark.parametrize("name", ["mawi_like", "livejournal_like"])
def test_sellcs_arrays_equal(name, c, sigma):
    jc, tc = _pair(name)
    js = j_coo_to_sellcs(jc, c=c, sigma=sigma)
    ts = TSC.coo_to_sellcs(tc, c=c, sigma=sigma)
    for f in ("data", "cols", "slice_ptr", "slice_of", "row_perm",
              "row_len"):
        a, b = _np(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (ts.shape, ts.chunk, ts.sigma, ts.nnz, ts.structure) == \
        (js.shape, js.chunk, js.sigma, js.nnz, js.structure)
    assert ts.storage_bytes() == js.storage_bytes()
    assert ts.fill_ratio == pytest.approx(js.fill_ratio)
    # round trip back to the same triplets
    rt = ts.to_coo()
    assert rt.nnz == tc.nnz
    np.testing.assert_allclose(rt.todense().numpy(), tc.todense().numpy())


def test_sellcs_defaults_kept():
    assert TSC.DEFAULT_C == 128 and TSC.DEFAULT_SIGMA_SLICES == 16
    jc, tc = _pair("hhh_like")
    js, ts = j_coo_to_sellcs(jc), TSC.coo_to_sellcs(tc)
    assert (ts.chunk, ts.sigma) == (js.chunk, js.sigma)


@pytest.mark.parametrize("P", [8, 16, 64])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_merge_plan_arrays_equal(name, P):
    jc, tc = _pair(name)
    jr, tr = J.coo_to_csr(jc), TC.coo_to_csr(tc)
    jp, tp = j_merge_plan(jr, P), TMS.merge_plan(tr, P)
    for f in ("cols", "vals", "seg", "row_starts"):
        a, b = _np(getattr(jp, f)), getattr(tp, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tp.r_width == jp.r_width
    # span lengths: the exact nnz split, which the interop rule recovers
    # from the reference plan up to harmless trailing padding
    _, nnz_starts = TMP.merge_path_partition_np(tr.host_arrays()[0], P)
    np.testing.assert_array_equal(tp.span_len.numpy(), np.diff(nnz_starts))
    rule = interop.span_lengths(_np(jp.seg), _np(jp.row_starts))
    ln = tp.span_len.numpy()
    assert np.all(rule >= ln)
    pad_kept = rule > ln
    seg = _np(jp.seg)
    # padding is kept only where every real item sits in local row 0
    assert np.all(seg[pad_kept].max(axis=1, initial=0) == 0)


def test_merge_plan_cached_once_per_csr():
    _, tc = _pair("mawi_like")
    csr = TC.coo_to_csr(tc)
    p1 = TMS.cached_merge_plan(csr)
    assert TMS.cached_merge_plan(csr) is p1
    assert p1.num_spans == TMS.default_num_spans(csr.shape[0], csr.nnz)
    assert TMS.cached_merge_plan(csr, 16) is not p1
    assert sorted(csr.plans) == [p1.num_spans, 16]
    assert TMS.default_num_spans(10 ** 6, 12 * 10 ** 6) == 1024
    assert TMS.default_num_spans(100, 100) == 8


@pytest.mark.parametrize("P", [1, 7, 33])
def test_merge_path_partition_equal(P):
    jc, _ = _pair("mawi_like")
    row_ptr = _np(J.coo_to_csr(jc).row_ptr)
    a = J.merge_path_partition_np(row_ptr, P)
    b = TMP.merge_path_partition_np(row_ptr, P)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["mawi_like", "hhh_like"])
def test_coo_fingerprint_same_digest(name):
    jc, tc = _pair(name)
    assert t_fingerprint(tc) == j_fingerprint(jc)
    # a permuted triplet stream hashes the same; a changed value does not
    r, c, v = tc.host_triplets()
    perm = np.random.default_rng(0).permutation(r.size)
    from repro_torch.core.formats import COO
    pc = COO(torch.from_numpy(r[perm]), torch.from_numpy(c[perm]),
             torch.from_numpy(v[perm]), tc.shape)
    assert t_fingerprint(pc) == t_fingerprint(tc)
    v2 = v.copy()
    v2[0] += 1.0
    vc = COO(tc.rows, tc.cols, torch.from_numpy(v2), tc.shape)
    assert t_fingerprint(vc) != t_fingerprint(tc)


def test_interop_round_trips_reference_storage():
    jc, tc = _pair("mawi_like")
    coo = interop.coo_from_arrays(
        {"rows": _np(jc.rows), "cols": _np(jc.cols), "data": _np(jc.data),
         "shape": jc.shape}, device=CPU)
    assert t_fingerprint(coo) == t_fingerprint(tc)
    jr = J.coo_to_csr(jc)
    csr = interop.csr_from_arrays(
        {"row_ptr": _np(jr.row_ptr), "col_ind": _np(jr.col_ind),
         "data": _np(jr.data), "shape": jr.shape}, device=CPU)
    np.testing.assert_array_equal(csr.row_ptr.numpy(), _np(jr.row_ptr))
    js = j_coo_to_sellcs(jc, c=32, sigma=64)
    d = {f: _np(getattr(js, f)) for f in ("data", "cols", "slice_ptr",
                                          "slice_of", "row_perm", "row_len")}
    d.update(shape=js.shape, chunk=js.chunk, sigma=js.sigma, nnz=js.nnz)
    sc = interop.sellcs_from_arrays(d, device=CPU)
    ts = TSC.coo_to_sellcs(tc, c=32, sigma=64)
    assert sc.storage_bytes() == ts.storage_bytes()
    np.testing.assert_array_equal(sc.cols.numpy(), ts.cols.numpy())
    jp = j_merge_plan(jr, 16)
    plan = interop.merge_plan_from_arrays(
        {"cols": _np(jp.cols), "vals": _np(jp.vals), "seg": _np(jp.seg),
         "row_starts": _np(jp.row_starts), "r_width": jp.r_width},
        device=CPU)
    assert plan.num_spans == 16 and plan.r_width == jp.r_width


def test_unported_formats_raise_naming_their_slice():
    # every format is ported now: a blocked conversion equals the
    # reference's array for array
    jc, tc = _pair("hhh_like")
    jb, tb = J.convert(jc, "bcohc"), TC.convert(tc, "bcohc")
    assert isinstance(tb, TC.BlockedSparse)
    for f in ("block_rows", "block_cols", "block_ptr", "packed", "data",
              "blk_col_inc", "blk_row_jump"):
        np.testing.assert_array_equal(_np(getattr(jb, f)),
                                      getattr(tb, f).numpy())
    assert tb.storage_bytes() == jb.storage_bytes()
    # one-triangle storage is ported; an asymmetric input is refused
    with pytest.raises(ValueError, match="A == A"):
        TSC.coo_to_sellcs(tc, structure="symmetric")
    with pytest.raises(ValueError):
        TSC.coo_to_sellcs(tc, c=0)
    assert isinstance(TC.convert(tc, "sellcs"), TSC.SellCS)
    assert TC.convert(tc, "merge").nnz == tc.nnz


def test_entry_points_default_to_cuda():
    trip = TM.test_suite(0.01)["hhh_like"].make()
    if torch.cuda.is_available():
        assert TM.as_coo(trip).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TM.as_coo(trip)


# --------------------------------------------------------------------------
# selector and roofline (pure Python)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mawi_like", "hhh_like", "road_like"])
def test_matrix_stats_and_select_equal(name):
    jc, tc = _pair(name)
    js, ts = J.matrix_stats(jc), TS.matrix_stats(tc)
    assert dataclass_tuple(js) == dataclass_tuple(ts)
    for k in (1, 8, 64):
        assert TS.select(ts, TS.MachineSpec(1), num_spmvs=100, k=k) == \
            J.select(js, J.MachineSpec(1), num_spmvs=100, k=k)
    for k, nd in ((8, 1), (32, 1), (32, 8)):
        a = J.select_distributed(js, k=k, num_devices=nd)
        b = TS.select_distributed(ts, k=k, num_devices=nd)
        assert tuple(a) == tuple(b)
    assert TS.break_even_spmvs("bcohc", numa_like=True, low_density=False) \
        == J.break_even_spmvs("bcohc", numa_like=True, low_density=False)
    assert TS.ZERO_CONVERSION_ALGO == "merge"


def dataclass_tuple(s):
    return (s.m, s.n, s.nnz, s.max_row_nnz, pytest.approx(s.row_var),
            s.symmetric)


def test_roofline_model_equal_at_same_constants():
    from repro.roofline import analysis as JA
    from repro_torch.roofline import analysis as TA
    kw = dict(hbm_bw=2e12, link_bw=1e11)
    for sched in ("row", "merge"):
        for k in (1, 32):
            a = JA.spmm_distributed_time(10 ** 5, 10 ** 5, k, 4, sched,
                                         nnz=10 ** 6, max_row_nnz=500,
                                         num_chunks=2, **kw)
            b = TA.spmm_distributed_time(10 ** 5, 10 ** 5, k, 4, sched,
                                         nnz=10 ** 6, max_row_nnz=500,
                                         num_chunks=2, **kw)
            assert a == pytest.approx(b)
    assert TA.csr_stream_bytes(100, 10) == JA.csr_stream_bytes(100, 10)
    assert TA.spmm_arithmetic_intensity(1000, 50, 50, 8) == \
        pytest.approx(JA.spmm_arithmetic_intensity(1000, 50, 50, 8))
    # H100 data-sheet constants, not the TPU's
    assert TA.HBM_BW == 3.35e12 and TA.PEAK_FLOPS_FP32 == 67e12
    assert TA.ridge_intensity() == pytest.approx(67e12 / 3.35e12)


# --------------------------------------------------------------------------
# obs (pure stdlib + torch)
# --------------------------------------------------------------------------
def test_obs_registry_and_ledger_match_reference():
    from repro import obs as JO
    from repro_torch import obs as TO
    vals = np.random.default_rng(0).standard_normal(50).tolist()
    hj = JO.MetricRegistry().histogram("x")
    ht = TO.MetricRegistry().histogram("x")
    for v in vals:
        hj.observe(v)
        ht.observe(v)
    assert ht.percentiles() == hj.percentiles()
    lj, lt = JO.ResidualLedger(), TO.ResidualLedger()
    for i, v in enumerate((2.0, 0.5, 3.0)):
        lab = TO.choice_labels(schedule="merge", num_chunks=i + 1)
        lj.record("f", v, 1.0, **lab)
        lt.record("f", v, 1.0, **lab)
    assert lt.correction(schedule="merge") == \
        pytest.approx(lj.correction(schedule="merge"))
    assert lt.as_dicts() == lj.as_dicts()
    assert TO.MetricRegistry.SCHEMA == "repro.obs/v1"


def test_obs_span_nesting_and_disabled_singleton():
    from repro_torch import obs as TO
    assert TO.span("a") is TO.span("b")          # disabled: one singleton
    reg = TO.MetricRegistry()
    with TO.span("flush", registry=reg):
        with TO.span("multiply", registry=reg):
            pass
        with TO.span("spmm/kernel", registry=reg):
            pass
    names = sorted(h.name for h in reg.histograms())
    assert names == ["flush", "flush/multiply", "spmm/kernel"]
    t = TO.time_min_of_n(lambda: torch.ones(3), reps=2, warmup=1)
    assert t.best_s >= 0 and t.reps == 2
    assert hashlib.sha256(b"").hexdigest()      # stdlib present
