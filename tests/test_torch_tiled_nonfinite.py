"""K6's and K7's plain versions against the JAX package's Pallas kernels
(interpret mode) when X holds NaN or Inf, on the CPU.

The reference multiplies each stored 8x128 tile densely, so a NaN or Inf
in X reaches every row of every stored tile over its 128-row X block,
through the tile's stored zeros (0 * Inf = NaN). The CUDA kernels skip
stored zeros and must keep that answer (``csrc/tiled_spmm.cu``); these
tests pin it on the plain versions that the kernels are held against on
the card. Finite entries agree within ``1e-5 * max(1, max|ref|)`` (both
round X to the tile dtype and sum in float32, in another order); NaN
and Inf must sit at the same places.

One difference is the reference's own: it pads the tile stream to a
multiple of its tiles per grid step with zero tiles at tile (0, 0), and
those carry a NaN or Inf of X block 0 into rows 0..7 although no stored
tile puts them there. The port has no padding tiles (recorded in
ROADMAP.md's queue of faults of the reference);
``test_reference_padding_tiles_reach_x_block_0`` shows the difference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro.kernels import coo_to_tiled as j_coo_to_tiled
from repro.kernels import ops as JOPS
from repro.spmm import kernels as JK

from repro_torch.data import matrices as TM
from repro_torch.kernels import bsr_spmv as TBSR
from repro_torch.kernels import coo_to_tiled
from repro_torch.spmm import kernels as TK

M, N, K = 64, 700, 3            # 6 X blocks, the last one ragged
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrix():
    """Seeded triplets whose columns 130..259 (X block 1) and 400..511
    (block 3) hold nonzeros only at their first 8 columns, so the rest of
    those blocks is touched by stored zeros alone."""
    rng = np.random.default_rng(11)
    rows = rng.integers(0, M, 240)
    cols = rng.integers(0, N, 240)
    quiet = ((cols >= 136) & (cols < 256)) | ((cols >= 392) & (cols < 512))
    rows, cols = rows[~quiet], cols[~quiet]
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (M, N)


@pytest.fixture(scope="module", params=sorted(DTYPES))
def streams(request):
    jdt, tdt = DTYPES[request.param]
    trip = _matrix()
    jt = j_coo_to_tiled(J.to_coo(*trip), "csb", dtype=jdt)
    tt = coo_to_tiled(TM.as_coo(trip, device="cpu"), "csb", dtype=tdt)
    np.testing.assert_array_equal(np.asarray(jt.tile_cols),
                                  tt.tile_cols.numpy())
    return jt, tt


def _x(case):
    X = np.random.default_rng(5).standard_normal((N, K)).astype(np.float32)
    if case in ("nan", "nan_inf"):
        X[200, 1] = np.nan           # block 1, a column no nonzero touches
    if case in ("inf", "nan_inf"):
        X[450, 2] = -np.inf          # block 3, the same
    if case == "overflow":           # finite in f32, Inf once rounded to bf16
        X[300, 0] = 3.4e38
    return X


def _same(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    tol = 1e-5 * max(1.0, float(np.abs(want[fin]).max()))
    assert float(np.abs(got[fin] - want[fin]).max()) <= tol


@pytest.mark.parametrize("case", ["nan", "inf", "nan_inf", "overflow"])
def test_plain_versions_carry_nonfinite_x_like_the_reference(streams, case):
    jt, tt = streams
    X = _x(case)
    want6 = np.asarray(JK.tiled_spmm(jt, jnp.asarray(X), k_tile=2,
                                     interpret=True))
    want7 = np.asarray(JOPS.bsr_spmm(jt, jnp.asarray(X), interpret=True))
    np.testing.assert_array_equal(np.isnan(want6), np.isnan(want7))
    Xt = torch.from_numpy(X)
    _same(TK.tiled_spmm_plain(tt, Xt), want6)
    _same(TBSR.bsr_spmm_plain(tt, Xt), want7)
    # the wrappers take the plain versions for CPU tensors, any k_tile
    _same(TK.tiled_spmm(tt, Xt, k_tile=1), want6)
    if case == "overflow" and tt.tiles.dtype == torch.float32:
        assert np.isfinite(want6).all()
    else:
        # every row of a stored tile over the bad block is non-finite
        assert (~np.isfinite(want6)).sum() >= 8


def test_reference_padding_tiles_reach_x_block_0():
    trip = _matrix()
    jt = j_coo_to_tiled(J.to_coo(*trip), "csb")
    tt = coo_to_tiled(TM.as_coo(trip, device="cpu"), "csb")
    assert tt.num_tiles % 8                    # the reference pads
    X = _x("finite")
    X[5, 1] = np.nan                           # X block 0
    want = np.asarray(JOPS.bsr_spmm(jt, jnp.asarray(X), interpret=True))
    got = TBSR.bsr_spmm_plain(tt, torch.from_numpy(X)).numpy()
    # tile row 0 over X block 0 is stored or not; where it is not, only
    # the reference's padding tiles put the NaN into rows 0..7
    stored = bool(((tt.tile_rows == 0) & (tt.tile_cols == 0)).any())
    assert np.isnan(want[:8, 1]).all()
    assert np.isnan(got[:8, 1]).all() == stored
    rest = np.ones(M, bool)
    rest[:8] = False
    _same(got[rest], want[rest])
