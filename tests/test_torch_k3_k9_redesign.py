"""The contracts around the redesigned K3 (SELL-C-σ transpose) and K9's
decode kernel, against the JAX package on the CPU.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them against these plain versions); here the same seeded numpy
inputs go through the reference (its Pallas kernels in interpret mode)
and through the port's plain versions and the Python around the kernels:
the group padding's per-tile row counts, the plain K9 with them, the
route ``kernels.ops.moe_group_matmul`` takes from the shapes, K3's plain
version on a slice deeper than the kernel's depth chunk, and K3's column
bands. Tolerance: float32, ``rtol = atol = 2e-4`` (the reference suite's;
the sums run in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro import spmm as JS
from repro.kernels import moe_group_matmul as JK9
from repro.kernels import ops as JOPS
from repro.spmm import kernels as JK
from repro.spmm import reference as JR

from repro_torch.data import matrices as TM
from repro_torch.interop import _float_t
from repro_torch.kernels import moe_group_matmul as TK9
from repro_torch.kernels import ops as TOPS
from repro_torch.spmm import coo_to_sellcs
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import reference as TR
from torch_threads import two_threads  # noqa: F401 (autouse)

RTOL = ATOL = 2e-4
M_TILE = 128


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _reference_layout(sizes):
    """The reference's padded layout in numpy (``repro.kernels.ops.
    moe_group_matmul``): each token's padded row and the padded length."""
    sizes = np.asarray(sizes, np.int64)
    T, E = int(sizes.sum()), sizes.size
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    padded_ptr = np.concatenate([[0], np.cumsum(-(-sizes // M_TILE)
                                                * M_TILE)])
    tok = np.arange(T)
    expert = np.searchsorted(ptr[1:], tok, side="right")
    pos = padded_ptr[expert] + (tok - ptr[expert])
    t_pad = -(-T // M_TILE) * M_TILE + E * M_TILE
    return pos, t_pad


# --------------------------------------------------------------------------
# K9: the per-tile row counts and the decode route
# --------------------------------------------------------------------------
@pytest.mark.parametrize("sizes", [[0, 1, 31, 32], [127, 128, 129, 0],
                                   [300, 0, 1, 129, 0, 32]])
def test_tile_rows_count_the_reference_layout(sizes):
    pos, t_pad = _reference_layout(sizes)
    tokens = torch.randn((len(pos), 4))
    gp = TOPS.moe_group_pad(tokens, torch.tensor(sizes), len(sizes), 128)
    want = np.bincount(pos // M_TILE, minlength=t_pad // M_TILE)
    assert gp.lhs.shape[0] == t_pad
    assert gp.pos.tolist() == pos.tolist()
    assert gp.tile_rows.dtype == torch.int32
    assert gp.tile_rows.tolist() == want.tolist()
    # past the real padded length every tile is empty
    assert int(gp.tile_rows[int(gp.n_rows) // M_TILE:].sum()) == 0


@pytest.mark.parametrize("lhs_dtype", ["f32", "bf16"])
def test_plain_with_tile_rows_matches_pallas_on_real_rows(lhs_dtype):
    """K9's plain version given the tiles' row counts (what the decode
    kernel computes) against the Pallas kernel in interpret mode: equal
    on every real row, zero on the rows past each tile's count."""
    rng = np.random.default_rng(18)
    sizes = [10, 0, 31, 1]
    E, K, N = len(sizes), 128, 128
    tokens = rng.standard_normal((sum(sizes), K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * .1).astype(np.float32)
    gp = TOPS.moe_group_pad(torch.from_numpy(tokens), torch.tensor(sizes),
                            E, K)
    lhs = gp.lhs.numpy()
    if lhs_dtype == "bf16":
        jl = jnp.asarray(lhs, jnp.bfloat16)
        tl = _float_t(np.asarray(jl), "cpu")
    else:
        jl, tl = jnp.asarray(lhs), torch.from_numpy(lhs)
    want = np.asarray(JK9.moe_group_matmul_padded(
        jl, jnp.asarray(w), jnp.asarray(gp.tile_expert.numpy()),
        interpret=True))
    tw = torch.from_numpy(w)
    got = TK9.moe_group_matmul_padded_plain(
        tl, tw, gp.tile_expert, n_rows=gp.n_rows, tile_rows=gp.tile_rows)
    real = np.zeros(lhs.shape[0], bool)
    real[gp.pos.numpy()] = True
    _close(got[torch.from_numpy(real)], want[real])
    assert float(got[torch.from_numpy(~real)].abs().max()) == 0.0
    # the decode wrapper takes the same plain version for CPU tensors,
    # uncounted; so does the tiled wrapper given the counts
    before = TK9.moe_group_matmul_decode.launches
    dec = TK9.moe_group_matmul_decode(tl, tw, gp.tile_expert, gp.tile_rows,
                                      n_rows=gp.n_rows)
    assert torch.equal(dec, got)
    assert TK9.moe_group_matmul_decode.launches == before
    assert torch.equal(TK9.moe_group_matmul_padded(
        tl, tw, gp.tile_expert, n_rows=gp.n_rows, tile_rows=gp.tile_rows),
        got)


def test_moe_group_matmul_picks_the_route_from_shapes(monkeypatch):
    """``ops.moe_group_matmul`` takes the decode kernel when the rows
    average at most ``DECODE_ROWS_PER_EXPERT`` an expert, the tiled one
    otherwise, from the shapes alone (the group sizes are not read), and
    both routes give the reference's answer."""
    calls = []
    for name in ("moe_group_matmul_decode", "moe_group_matmul_padded"):
        real = getattr(TK9, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(TK9, name, spy)
    E, K, N = 4, 128, 128
    limit = TOPS.DECODE_ROWS_PER_EXPERT * E
    assert TOPS.takes_decode_kernel(limit, E)
    assert not TOPS.takes_decode_kernel(limit + 1, E)
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((E, K, N)) * .1).astype(np.float32)
    for rows, sizes, route in (
            (limit, [limit, 0, 0, 0], "moe_group_matmul_decode"),
            (limit + 1, [1, 0, 0, limit], "moe_group_matmul_padded")):
        tokens = rng.standard_normal((rows, K)).astype(np.float32)
        calls.clear()
        got = TOPS.moe_group_matmul(torch.from_numpy(tokens),
                                    torch.from_numpy(w),
                                    torch.tensor(sizes))
        assert calls == [route]
        want = JOPS.moe_group_matmul(jnp.asarray(tokens), jnp.asarray(w),
                                     jnp.asarray(sizes, jnp.int32),
                                     interpret=True)
        _close(got, want)
    calls.clear()
    TOPS.moe_group_matmul(torch.from_numpy(tokens), torch.from_numpy(w),
                          torch.tensor(sizes), plain=True)
    assert calls == []


# --------------------------------------------------------------------------
# K3: the plain version on a deep slice, and the column bands
# --------------------------------------------------------------------------
def _deep_slice_trip(seed=3):
    """A 96 x 160 matrix whose row 5 holds 150 entries (a slice 150
    width-rows deep at C = 32: several of the kernel's 16-deep chunks),
    sparse rows around it and empty rows 32..63 (an empty slice)."""
    r = np.random.default_rng(seed)
    rows = np.concatenate([np.full(150, 5), r.integers(0, 32, 300),
                           r.integers(64, 96, 200)])
    cols = np.concatenate([r.permutation(160)[:150],
                           r.integers(0, 160, 500)])
    keys = np.unique(rows * 160 + cols)
    vals = r.standard_normal(keys.size).astype(np.float32)
    return ((keys // 160).astype(np.int32), (keys % 160).astype(np.int32),
            vals, (96, 160))


@pytest.mark.parametrize("k", [1, 3, 33])
def test_k3_plain_matches_pallas_on_a_deep_slice(k):
    trip = _deep_slice_trip()
    jc, tc = J.to_coo(*trip), TM.as_coo(trip, device="cpu")
    js = JS.coo_to_sellcs(jc, c=32, sigma=32)
    ts = coo_to_sellcs(tc, c=32, sigma=32)
    widths = (ts.slice_ptr[1:] - ts.slice_ptr[:-1]).tolist()
    assert max(widths) == 150 and 0 in widths
    X = np.random.default_rng(k).standard_normal((96, k)).astype(np.float32)
    xs = np.asarray(JR.sellcs_slot_x(js.row_perm, jnp.asarray(X), 96))
    want = np.asarray(JK.sellcs_slots_t(
        js.data, js.cols, js.slice_of, jnp.asarray(xs), n_out=160,
        chunk=32, k_tile=k, interpret=True))
    txs = TR.sellcs_slot_x(ts.row_perm, torch.from_numpy(X), 96)
    got = TK.sellcs_slots_t_plain(ts.data, ts.cols, ts.slice_of,
                                  ts.slice_ptr, ts.row_len, txs, n_out=160,
                                  chunk=32)
    assert got.shape == (160, k)
    _close(got, want)
    # the wrapper takes it for CPU tensors, uncounted
    before = TK.sellcs_slots_t.launches
    _close(TK.sellcs_slots_t(ts.data, ts.cols, ts.slice_of, ts.slice_ptr,
                             ts.row_len, txs, n_out=160, chunk=32), want)
    assert TK.sellcs_slots_t.launches == before


def test_k3_column_bands_follow_l2():
    """One pass while Y fits two thirds of L2; else bands of at most that
    many bytes, never more bands than columns."""
    l2 = 50 * 2 ** 20
    assert TK.column_bands(2 ** 20, 1, l2) == 1            # rmat 20, k=1
    assert TK.column_bands(2 ** 20, 32, l2) == 4           # 128 MiB Y
    assert TK.column_bands(2 ** 20, 16, l2) == 2           # 64 MiB
    assert TK.column_bands(2 ** 20, 8, l2) == 1            # 32 MiB
    assert TK.column_bands(3, 2 ** 30, l2) == 3
    assert TK.column_bands(0, 32, l2) == 1
