"""repro_torch blocked-format slice against the JAX package.

The same seeded numpy inputs go through the JAX function and its port:

* curve keys, ``block_size_for`` and every ``ICRS``/``BICRS``/
  ``BlockedSparse``/``TiledSparse`` array must be equal exactly;
* the oracles (``spmv_incremental``, ``spmv_blocked``, ``bsr_spmv_ref``,
  ``bsr_spmm_ref``) agree within ``rtol = atol = 2e-4`` (float32 sums in
  another order);
* the kernels' plain versions (what K5, K6 and K7 run for CPU tensors)
  agree with the Pallas kernels run in interpret mode within
  ``1e-5 * max(1, max|ref|)`` — both round x to the tile dtype and sum in
  float32, in another order.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro.core import curves as JCV
from repro.kernels import coo_to_tiled as j_coo_to_tiled
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.spmm import SparseOperator as JOperator
from repro.spmm import kernels as JK
from repro.spmm import spmm_blocked as j_spmm_blocked

from repro_torch import interop
from repro_torch.core import curves as TCV
from repro_torch.core import spmv as t_spmv
from repro_torch.core import spmv_blocked, spmv_incremental
from repro_torch.data import matrices as TM
from repro_torch.kernels import coo_to_tiled
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.spmm import SparseOperator, spmm, spmm_ref
from repro_torch.spmm import kernels as TK

TC = importlib.import_module("repro_torch.core.convert")
JCONV = importlib.import_module("repro.core.convert")

CPU = "cpu"
RTOL, ATOL = 2e-4, 2e-4
BLOCKED = [a for a, s in TC.ALGORITHM_SPECS.items() if s.blocked]
TILED_ORDERS = ["mergeb", "csb", "bcohch"]      # row, Morton, Hilbert


def _pair(name, scale=0.01):
    trip = TM.test_suite(scale)[name].make()
    return J.to_coo(*trip), TM.as_coo(trip, device=CPU)


def _x(n, k=None, seed=0):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eq(j_arr, t_arr):
    a, b = np.asarray(j_arr), t_arr.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _close_rel(got, want):
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


def test_curve_keys_equal_reference():
    rng = np.random.default_rng(0)
    r = np.concatenate([rng.integers(0, 2 ** 16, 3000),
                        rng.integers(0, 2 ** 20, 50), [0, 65535]])
    c = np.concatenate([rng.integers(0, 2 ** 16, 3000),
                        rng.integers(0, 2 ** 20, 50), [65535, 0]])
    jr, jc = jnp.asarray(r), jnp.asarray(c)
    tr, tc = torch.from_numpy(r), torch.from_numpy(c)
    for order in ("row", "morton", "hilbert"):
        np.testing.assert_array_equal(
            np.asarray(JCV.curve_key(jr, jc, order, 16)).astype(np.int64),
            TCV.curve_key(tr, tc, order, 16).numpy())
    for bits in (3, 9, 16):
        key = np.asarray(JCV.hilbert_key(jr, jc, bits))
        np.testing.assert_array_equal(
            key.astype(np.int64), TCV.hilbert_key(tr, tc, bits).numpy())
        for a, b in zip(JCV.hilbert_decode(jnp.asarray(key), bits),
                        TCV.hilbert_decode(torch.from_numpy(
                            key.astype(np.int64)), bits)):
            _eq(a, b)
        np.testing.assert_array_equal(JCV.hilbert_key_np(r, c, bits),
                                      TCV.hilbert_key_np(r, c, bits))
    mk = np.asarray(JCV.morton_key(jr, jc))
    for a, b in zip(JCV.morton_decode(jnp.asarray(mk)),
                    TCV.morton_decode(torch.from_numpy(
                        mk.astype(np.int64)))):
        _eq(a, b)


def test_block_size_for_equal_reference():
    for shape in ((1, 1), (64, 64), (655, 655), (1296, 1296), (4096, 4096),
                  (10 ** 6, 10 ** 6), (100, 2 ** 31 - 1)):
        for fmt in ("packed_coo", "icrs"):
            assert TC.block_size_for(shape, in_block_format=fmt) == \
                JCONV.block_size_for(shape, in_block_format=fmt)


@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_incremental_formats_equal_and_oracle(name):
    jc, tc = _pair(name)
    x = _x(tc.shape[1])
    want = np.asarray(J.spmv_coo(jc, jnp.asarray(x)))
    for jm, tm in ((J.coo_to_icrs(jc), TC.coo_to_icrs(tc)),
                   *((J.coo_to_bicrs(jc, o), TC.coo_to_bicrs(tc, o))
                     for o in ("hilbert", "morton", "row"))):
        assert int(jm.col_start) == tm.col_start
        for f in ("col_inc", "row_jump", "data"):
            _eq(getattr(jm, f), getattr(tm, f))
        assert tm.storage_bytes() == jm.storage_bytes()
        jd, td = jm.to_coo(), tm.to_coo()
        for f in ("rows", "cols", "data"):
            _eq(getattr(jd, f), getattr(td, f))
        np.testing.assert_allclose(
            spmv_incremental(tm, torch.from_numpy(x)).numpy(),
            np.asarray(J.spmv_incremental(jm, jnp.asarray(x))),
            rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            spmv_incremental(tm, torch.from_numpy(x)).numpy(), want,
            rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("algo", BLOCKED)
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_blocked_arrays_equal_reference(name, algo):
    jc, tc = _pair(name)
    kw = {"num_bands": 4} \
        if TC.ALGORITHM_SPECS[algo].scheduling == "static_rows" else {}
    jb, tb = J.convert(jc, algo, **kw), TC.convert(tc, algo, **kw)
    for f in ("block_rows", "block_cols", "block_ptr", "packed", "data",
              "grid_ptr", "blk_col_inc", "blk_row_jump", "blk_row_ptr"):
        _eq(getattr(jb, f), getattr(tb, f))
    for f in ("shape", "beta", "grid", "block_storage", "block_order",
              "in_block_format", "in_block_order", "row_bands"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert tb.storage_bytes() == jb.storage_bytes()
    assert tb.num_blocks == jb.num_blocks
    for a, b in zip(jb.local_rows_cols(), tb.local_rows_cols()):
        _eq(a, b)
    _eq(jb.block_of_nnz(), tb.block_of_nnz())
    jd, td = jb.to_coo(), tb.to_coo()
    for f in ("rows", "cols", "data"):
        _eq(getattr(jd, f), getattr(td, f))
    X = _x(tc.shape[1], 3)
    np.testing.assert_allclose(
        spmv_blocked(tb, torch.from_numpy(X[:, 0])).numpy(),
        np.asarray(J.spmv_blocked(jb, jnp.asarray(X[:, 0]))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        spmm_ref(tb, torch.from_numpy(X)).numpy(),
        np.asarray(j_spmm_blocked(jb, jnp.asarray(X))), rtol=RTOL,
        atol=ATOL)
    # the reference's storage carried across gives the same object
    d = {f: np.asarray(getattr(jb, f)) for f in (
        "block_rows", "block_cols", "block_ptr", "packed", "data",
        "grid_ptr", "blk_col_inc", "blk_row_jump", "blk_row_ptr")}
    d.update({f: getattr(jb, f) for f in (
        "shape", "beta", "grid", "block_storage", "block_order",
        "in_block_format", "in_block_order", "row_bands")})
    ib = interop.blocked_from_arrays(d, device=CPU)
    assert torch.equal(ib.packed.view(torch.int32),
                       tb.packed.view(torch.int32))
    assert ib.row_bands == tb.row_bands


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("algo", TILED_ORDERS)
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_tiled_arrays_equal_reference(name, algo, dtype):
    jc, tc = _pair(name)
    kw = {"num_bands": 4} if algo == "bcohch" else {}
    jt = j_coo_to_tiled(jc, algo, dtype=getattr(jnp, dtype), **kw)
    tt = coo_to_tiled(tc, algo, dtype=getattr(torch, dtype), **kw)
    _eq(jt.tile_rows, tt.tile_rows)
    _eq(jt.tile_cols, tt.tile_cols)
    np.testing.assert_array_equal(np.asarray(jt.tiles.astype(jnp.float32)),
                                  tt.tiles.float().numpy())
    assert tt.tiles.dtype == getattr(torch, dtype)
    assert (tt.shape, tt.beta, tt.order, tt.nnz, tt.num_tiles) == \
        (jt.shape, jt.beta, jt.order, jt.nnz, jt.num_tiles)
    assert tt.window_switches() == jt.window_switches()
    assert tt.fill_ratio == jt.fill_ratio
    assert tt.storage_bytes() == jt.storage_bytes()
    assert tt.padded_shape() == jt.padded_shape()


def test_tiled_memory_guard_and_empty_matrix():
    jc, tc = _pair("road_like")
    small = 100 * 8 * 128 * 4          # room for 100 f32 tiles
    with pytest.raises(MemoryError):
        j_coo_to_tiled(jc, "csb", max_bytes=small)
    with pytest.raises(MemoryError, match="GiB"):
        coo_to_tiled(tc, "csb", max_bytes=small)
    z = np.zeros(0, np.int32)
    empty = (z, z, np.zeros(0, np.float32), (64, 256))
    jt = j_coo_to_tiled(J.to_coo(*empty), "csb")
    tt = coo_to_tiled(TM.as_coo(empty, device=CPU), "csb")
    assert tt.num_tiles == jt.num_tiles == 1 and tt.nnz == 0
    assert float(tt.tiles.abs().sum()) == 0.0
    x = torch.ones(256)
    assert torch.equal(TOPS.bsr_spmv(tt, x), torch.zeros(64))


@pytest.mark.parametrize("name,scale", [("mawi_like", 0.005),
                                        ("road_like", 0.01)])
def test_tiled_oracles_match_reference(name, scale):
    jc, tc = _pair(name, scale)
    jt, tt = j_coo_to_tiled(jc, "csbh"), coo_to_tiled(tc, "csbh")
    X = _x(tc.shape[1], 5, 1)
    np.testing.assert_allclose(
        TREF.bsr_spmv_ref(tt, torch.from_numpy(X[:, 0])).numpy(),
        np.asarray(JREF.bsr_spmv_ref(jt, jnp.asarray(X[:, 0]))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        TREF.bsr_spmm_ref(tt, torch.from_numpy(X)).numpy(),
        np.asarray(JREF.bsr_spmm_ref(jt, jnp.asarray(X))), rtol=RTOL,
        atol=ATOL)
    # spmm "ref" and the spmv dispatch reach the tile oracles, which equal
    # the triplet oracle of the same matrix
    np.testing.assert_allclose(
        spmm(tt, torch.from_numpy(X), impl="ref").numpy(),
        spmm_ref(tc, torch.from_numpy(X)).numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        t_spmv(tt, torch.from_numpy(X[:, 1])).numpy(),
        spmm_ref(tc, torch.from_numpy(X[:, 1])).numpy(), rtol=RTOL,
        atol=ATOL)


# --------------------------------------------------------------------------
# plain versions of K5 / K6 / K7 against the Pallas kernels (interpret)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,scale,algo", [("mawi_like", 0.005, "csb"),
                                             ("road_like", 0.01, "bcohch")])
def test_k5_plain_matches_pallas(name, scale, algo, dtype):
    jc, tc = _pair(name, scale)
    jt = j_coo_to_tiled(jc, algo, dtype=getattr(jnp, dtype))
    tt = interop.tiled_from_arrays(
        {"tiles": np.asarray(jt.tiles), "tile_rows": np.asarray(jt.tile_rows),
         "tile_cols": np.asarray(jt.tile_cols), "shape": jt.shape,
         "beta": jt.beta, "order": jt.order, "nnz": jt.nnz}, device=CPU)
    assert tt.tiles.dtype == getattr(torch, dtype) and tt.num_tiles <= 300
    x = _x(tc.shape[1], seed=2)
    want = np.asarray(JOPS.bsr_spmv(jt, jnp.asarray(x), interpret=True))
    for got in (TOPS.bsr_spmv(tt, torch.from_numpy(x), plain=True),
                TOPS.bsr_spmv(tt, torch.from_numpy(x)),       # CPU -> plain
                spmm(tt, torch.from_numpy(x), impl="plain")):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close_rel(got.numpy(), want)


@pytest.mark.parametrize("k,k_tile", [(1, None), (8, None), (8, 3),
                                      (33, None), (33, 8)])
def test_k6_plain_matches_pallas(k, k_tile):
    jc, tc = _pair("road_like", 0.01)
    jt, tt = j_coo_to_tiled(jc, "csbh"), coo_to_tiled(tc, "csbh")
    assert tt.num_tiles <= 300
    X = _x(tc.shape[1], k, k)
    want = np.asarray(JK.tiled_spmm(jt, jnp.asarray(X), k_tile=k_tile,
                                    interpret=True))
    got = TK.tiled_spmm(tt, torch.from_numpy(X), k_tile=k_tile, plain=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_rel(got.numpy(), want)
    _close_rel(spmm(tt, torch.from_numpy(X), impl="plain",
                    k_tile=k_tile).numpy(), want)
    with pytest.raises(ValueError):
        TK.tiled_spmm(tt, torch.from_numpy(X), k_tile=k + 1)


@pytest.mark.parametrize("R", [1, 8, 33])
def test_k7_plain_matches_pallas(R):
    jc, tc = _pair("mawi_like", 0.005)
    jt = j_coo_to_tiled(jc, "mergebh", dtype=jnp.bfloat16)
    tt = coo_to_tiled(tc, "mergebh", dtype=torch.bfloat16)
    X = _x(tc.shape[1], R, 10 + R)
    want = np.asarray(JOPS.bsr_spmm(jt, jnp.asarray(X), interpret=True))
    got = TOPS.bsr_spmm(tt, torch.from_numpy(X), plain=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_rel(got.numpy(), want)


# --------------------------------------------------------------------------
# the operator / serve repair and the quickstart entry point
# --------------------------------------------------------------------------
def test_operator_realizes_blocked_plan_like_reference():
    """A plain SparseOperator whose selector picks a blocked format: the
    port used to raise NotImplementedError at convert; it must pick the
    reference's algorithm and give its answer, forward and transpose."""
    jc, tc = _pair("hhh_like", 0.02)
    jop = JOperator(jc, k_hint=1, num_spmvs=10)
    op = SparseOperator(tc, impl="plain", k_hint=1, num_spmvs=10)
    assert op.plan.label == jop.plan.spec.algorithm == "mergeb"
    assert op.plan.impl == "ref"
    X = _x(tc.shape[1], 4, 5)
    np.testing.assert_allclose(op.matmul(torch.from_numpy(X)).numpy(),
                               np.asarray(jop.matmul(jnp.asarray(X))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(op.rmatmul(torch.from_numpy(X)).numpy(),
                               np.asarray(jop.rmatmul(jnp.asarray(X))),
                               rtol=RTOL, atol=ATOL)


def test_serve_pinned_blocked_algorithm():
    from repro_torch.launch import serve
    res = serve.main(["--mode", "spmv", "--matrix", "mawi_like", "--scale",
                      "0.01", "--requests", "6", "--max-batch", "4",
                      "--reps", "1",
                      "--algorithm", "csb", "--device", "cpu",
                      "--impl", "plain"])
    assert res["op"].plan.label == "csb" and len(res["answers"]) == 6
    coo = res["op"]._coo
    for rid, x in zip(res["rids"], res["xs"]):
        np.testing.assert_allclose(res["answers"][rid].numpy(),
                                   spmm_ref(coo, x).numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_quickstart_on_cpu():
    from repro_torch.examples import quickstart, spmv_tour
    res = quickstart.main(["--device", "cpu", "--matrix", "mawi_like",
                           "--scale", "0.01"])
    assert set(res["errors"]) == set(TC.ALGORITHM_SPECS)
    assert res["k5_err"] <= res["tol"] and res["tiles"] > 0
    tour = spmv_tour.main(["--device", "cpu"])
    jt = J.coo_to_bicrs(J.to_coo([0, 0, 1, 2, 3, 3, 4, 5, 6, 7, 7],
                                 [1, 7, 2, 0, 3, 4, 6, 5, 2, 0, 7],
                                 np.arange(1, 12, dtype=np.float32), (8, 8)),
                        order="hilbert")
    _eq(jt.row_jump, tour["bicrs"].row_jump)
