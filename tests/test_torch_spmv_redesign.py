"""K5's zero-free tile operand and K4's carried plans, on the CPU, against
the JAX package.

K5 (``csrc/tiled_spmm.cu``) reads a zero-free copy of the tile stream,
built once per ``TiledSparse`` (``repro_torch.kernels.bsr_spmv.
_compact_tiles``): per tile, its stored nonzeros in visit order, each as a
packed in-tile position (with the tile's index modulo 32 above it) and a
value in the tile dtype. These tests hold the operand to the tiles it
comes from, exactly, and its plain SpMV (``compact_spmv_plain``, the
kernel's arithmetic: every stored nonzero, plus the stored zeros of each
tile over an X block with a NaN or Inf) to ``bsr_spmv_plain`` and to the reference's Pallas kernel in
interpret mode, within ``1e-5 * max(1, max|ref|)`` (float32 sums in
another order); NaN and Inf must sit at the same places.

K4 takes the reference's merge plan carried across by ``interop``, whose
depth D need not be a multiple of 4; the last test holds K4's plain
version on such a plan and on the port's own plan of the same matrix
(empty spans, a row across many spans: the cases the kernel's tests on
the card use) to the Pallas kernel.

The CUDA kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro.kernels import coo_to_tiled as j_coo_to_tiled
from repro.kernels import ops as JOPS
from repro.kernels.merge_spmv import merge_plan as j_merge_plan

from repro_torch import interop
from repro_torch.core import coo_to_csr
from repro_torch.data import matrices as TM
from repro_torch.kernels import bsr_spmv as TBSR
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels.tiling import TILE_C, TILE_R

CPU = "cpu"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiled_pair(name, scale, algo, dtype):
    """The reference's tile stream and the same one carried to the port."""
    jdt, tdt = DTYPES[dtype]
    jt = j_coo_to_tiled(J.to_coo(*TM.test_suite(scale)[name].make()), algo,
                        dtype=jdt)
    tt = interop.tiled_from_arrays(
        {"tiles": np.asarray(jt.tiles), "tile_rows": np.asarray(jt.tile_rows),
         "tile_cols": np.asarray(jt.tile_cols), "shape": jt.shape,
         "beta": jt.beta, "order": jt.order, "nnz": jt.nnz}, device=CPU)
    assert tt.tiles.dtype == tdt
    return jt, tt


def _same(got, want):
    """NaN and Inf at the same places, the finite values within
    ``1e-5 * max(1, max|want|)``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isinf(got)], want[np.isinf(want)])
    fin = np.isfinite(want)
    tol = 1e-5 * max(1.0, float(np.abs(want[fin]).max()))
    assert float(np.abs(got[fin] - want[fin]).max()) <= tol


def compact_spmv_plain(tt, x):
    """K5's arithmetic in plain PyTorch, on its operand: each stored
    nonzero times x (rounded to the tile dtype), added into its row; a
    tile over a 128-row X block that holds a NaN or Inf also adds its
    stored zeros' ``0 * x``, read from the dense tile. x [n] -> f32 [m],
    equal to ``bsr_spmv_plain`` up to the order of the sums."""
    c = TBSR._compact_tiles(tt)
    m, n = tt.shape
    mp, np_ = tt.padded_shape()
    xr = torch.zeros(np_, dtype=torch.float32)
    xr[:n] = x.to(tt.tiles.dtype).to(torch.float32)
    tile = torch.repeat_interleave(torch.arange(tt.num_tiles),
                                   c.nz_ptr.diff().long())
    p = c.pos[:c.nnz].long() % (TILE_R * TILE_C)
    rows = tt.tile_rows.long()[tile] * TILE_R + p // TILE_C
    cols = tt.tile_cols.long()[tile] * TILE_C + p % TILE_C
    y = torch.zeros(mp, dtype=torch.float32)
    y.index_add_(0, rows, c.vals[:c.nnz].to(torch.float32) * xr[cols])
    xb = xr.view(-1, TILE_C)
    bad = (~xb.isfinite().all(1))[tt.tile_cols.long()].nonzero().squeeze(1)
    if bad.numel():
        a = tt.tiles[bad].to(torch.float32)                   # [b, 8, 128]
        xa = xb[tt.tile_cols[bad].long()][:, None, :]          # [b, 1, 128]
        zeros = torch.where(a == 0, a * xa, torch.zeros_like(a)).sum(2)
        y.view(-1, TILE_R).index_add_(0, tt.tile_rows[bad].long(), zeros)
    return y[:m]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("algo", ["csb", "bcohch"])
@pytest.mark.parametrize("name,scale", [("road_like", 0.01),
                                        ("mawi_like", 0.005)])
def test_compact_operand_holds_the_tiles_nonzeros(name, scale, algo, dtype):
    """Every stored nonzero once, tile by tile in visit order and
    row-major within its tile, with its exact value and the tile's index
    modulo 32 above its position; the padding is zero; the kernel's work
    items cover every chunk's entries."""
    _, tt = _tiled_pair(name, scale, algo, dtype)
    c = TBSR._compact_tiles(tt)
    T = tt.num_tiles
    flat = tt.tiles.reshape(T, -1)
    counts = (flat != 0).sum(1)
    assert c.nnz == int(counts.sum()) > 0
    assert c.nz_ptr.dtype == torch.int32 and c.nz_ptr.shape == (T + 1,)
    assert torch.equal(c.nz_ptr.diff().long(), counts)
    L = c.pos.numel()
    assert L % 8 == 0 and L - c.nnz < 8 and c.vals.numel() == L
    assert c.vals.dtype == tt.tiles.dtype and c.pos.dtype == torch.int16
    assert not c.pos[c.nnz:].any() and not c.vals[c.nnz:].any()
    pos = c.pos[:c.nnz].long()
    tile = torch.repeat_interleave(torch.arange(T), counts)
    assert torch.equal(pos >> 10, tile % 32)
    inner = pos & 1023
    # strictly increasing within each tile: row-major, each position once
    same_tile = tile[1:] == tile[:-1]
    assert bool((inner[1:] > inner[:-1])[same_tile].all())
    # scattered back, the entries are the tiles, bit for bit
    back = torch.zeros_like(flat)
    back[tile, inner] = c.vals[:c.nnz]
    assert torch.equal(back, flat)
    # the kernel's work items cover each chunk of 32 tiles in order, in
    # spans of at most 1,024 entries starting at multiples of 8
    w = c.work.long()
    assert c.work.dtype == torch.int32 and w.shape[1] == 3
    chunks = -(-T // 32)
    assert torch.equal(w[:, 0].unique(), torch.arange(chunks))
    assert bool((w[1:, 0] >= w[:-1, 0]).all())
    assert bool((w[:, 1] % 8 == 0).all() and (w[:, 2] - w[:, 1] <= 1024).all())
    for ch in range(chunks):
        spans = w[w[:, 0] == ch]
        e0 = int(c.nz_ptr[32 * ch])
        e1 = int(c.nz_ptr[min(32 * ch + 32, T)])
        assert int(spans[0, 1]) == e0 - e0 % 8 and int(spans[-1, 2]) == e1
        assert torch.equal(spans[1:, 1], spans[:-1, 2])
    assert c.nbytes() == (4 * (T + 1) + 12 * w.shape[0]
                          + L * (2 + tt.tiles.element_size()))


def test_long_chunks_split_over_work_items():
    """A dense row over 40 tiles (128 nonzeros each): the first chunk's
    4,096+ entries become spans of at most 1,024 that end where the
    second chunk starts; the operand's SpMV still equals the dense
    product."""
    from repro_torch.kernels.tiling import TiledSparse
    rng = np.random.default_rng(12)
    t = np.zeros((40, 8, 128), np.float32)
    t[:, 3, :] = rng.standard_normal((40, 128))
    t[::3, 6, ::5] = 1.0
    tiles = torch.from_numpy(t)
    tt = TiledSparse(tiles, torch.full((40,), 2, dtype=torch.int32),
                     torch.arange(40, dtype=torch.int32), (24, 128 * 40),
                     0, "csb", int((tiles != 0).sum()))
    c = TBSR._compact_tiles(tt)
    w = c.work.long()
    first = w[w[:, 0] == 0]
    assert first.shape[0] >= 4 and int(first[-1, 2]) == int(c.nz_ptr[32])
    assert bool(((w[:, 2] - w[:, 1]) <= 1024).all())
    assert int(w[-1, 0]) == 1 and int(w[-1, 2]) == c.nnz
    x = torch.from_numpy(rng.standard_normal(128 * 40).astype(np.float32))
    _same(compact_spmv_plain(tt, x).numpy(),
          TBSR.bsr_spmv_plain(tt, x).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,scale,algo", [("mawi_like", 0.005, "csb"),
                                             ("road_like", 0.01, "bcohch")])
def test_compact_spmv_matches_plain_and_pallas(name, scale, algo, dtype):
    jt, tt = _tiled_pair(name, scale, algo, dtype)
    x = np.random.default_rng(3).standard_normal(tt.shape[1]).astype(
        np.float32)
    want = np.asarray(JOPS.bsr_spmv(jt, jnp.asarray(x), interpret=True))
    xt = torch.from_numpy(x)
    got = compact_spmv_plain(tt, xt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _same(got.numpy(), want)
    _same(got.numpy(), TBSR.bsr_spmv_plain(tt, xt).numpy())


def test_compact_operand_built_once_and_never_stale():
    """One build per TiledSparse, reused by every later call; replacing
    the tiles, or changing them in place, builds it anew."""
    _, tt = _tiled_pair("road_like", 0.01, "csb", "f32")
    assert tt._compact is None
    c = TBSR._compact_tiles(tt)
    assert tt._compact is c and c.build_s >= 0.0
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tt.shape[1]).astype(np.float32))
    y = compact_spmv_plain(tt, x)
    assert TBSR._compact_tiles(tt) is c
    # a copy made with dataclasses.replace starts without one
    twin = dataclasses.replace(tt, tiles=tt.tiles.clone())
    assert twin._compact is None
    # in place: the version moves, the operand follows
    tt.tiles.mul_(2.0)
    c2 = TBSR._compact_tiles(tt)
    assert c2 is not c and torch.equal(c2.vals[:c2.nnz], 2 * c.vals[:c.nnz])
    _same(compact_spmv_plain(tt, x).numpy(), 2 * y.numpy())
    # replaced: a new tensor, a new operand
    tt.tiles = torch.zeros_like(tt.tiles)
    c3 = TBSR._compact_tiles(tt)
    assert c3 is not c2 and c3.nnz == 0
    assert not compact_spmv_plain(tt, x).any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flagged_x_block_gives_the_dense_nan_and_inf(dtype):
    """A NaN, an Inf and (bf16) a finite x that rounds to Inf, each in an
    X block where only stored zeros of some tiles meet it: the dense tile
    product puts NaN into those tiles' rows, and so does the operand's
    plain SpMV, which reads the dense tiles of flagged blocks."""
    rows, cols, vals, (m, n) = TM.test_suite(0.02)["road_like"].make()
    q = [n // 4 + 3, n // 2 + 70, 3 * n // 4 + 127]     # emptied columns
    keep = ~np.isin(cols, q)
    jt = j_coo_to_tiled(J.to_coo(rows[keep], cols[keep], vals[keep], (m, n)),
                        "csb", dtype=DTYPES[dtype][0])
    tt = interop.tiled_from_arrays(
        {"tiles": np.asarray(jt.tiles), "tile_rows": np.asarray(jt.tile_rows),
         "tile_cols": np.asarray(jt.tile_cols), "shape": jt.shape,
         "beta": jt.beta, "order": jt.order, "nnz": jt.nnz}, device=CPU)
    assert min(q) >= 128          # the reference's padding tiles stay finite
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    x[q[0]], x[q[1]], x[q[2]] = np.nan, -np.inf, 3.4e38
    want = np.asarray(JOPS.bsr_spmv(jt, jnp.asarray(x), interpret=True))
    assert int(np.isnan(want).sum()) >= 16
    got = compact_spmv_plain(tt, torch.from_numpy(x)).numpy()
    _same(got, want)
    _same(got, TBSR.bsr_spmv_plain(tt, torch.from_numpy(x)).numpy())


def _k4_triplets():
    """A matrix whose merge plan at 203 spans has D % 4 != 0, spans with
    no nonzero (rows 1000..2599 are empty) and one row (11) across more
    than 20 spans. ``tests/test_torch_cuda.py`` builds the same one."""
    m = n = 3000
    rng = np.random.default_rng(8)
    diag = np.r_[0:1000, 2600:3000]
    rows = np.concatenate([np.full(n, 11), diag,
                           rng.integers(2600, 3000, 500)])
    cols = np.concatenate([np.arange(n), diag, rng.integers(0, n, 500)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


def test_k4_plain_on_carried_and_own_plans_with_odd_depth():
    """The reference's plan carried across (D = 39; its spans without a
    nonzero keep their padding, 39 items of local row 0) and the port's
    own plan of the same CSR (those spans have span_len 0): K4's plain
    version and the carry step give the Pallas kernel's answer on both."""
    rows, cols, vals, shape = _k4_triplets()
    jr = J.coo_to_csr(J.to_coo(rows, cols, vals, shape))
    jp = j_merge_plan(jr, 203)
    carried = interop.merge_plan_from_arrays(
        {"cols": np.asarray(jp.cols), "vals": np.asarray(jp.vals),
         "seg": np.asarray(jp.seg), "row_starts": np.asarray(jp.row_starts),
         "r_width": jp.r_width}, device=CPU)
    csr = coo_to_csr(TM.as_coo((rows, cols, vals, shape), device=CPU))
    own = TMS.merge_plan(csr, 203)
    assert carried.depth == own.depth and own.depth % 4
    assert bool((own.span_len == 0).any())
    assert bool((carried.span_len == carried.depth).sum() > 20)
    x = np.random.default_rng(9).standard_normal(shape[1]).astype(np.float32)
    want = np.asarray(JOPS.merge_spmv(jr, jnp.asarray(x), plan=jp,
                                      interpret=True))
    for plan in (carried, own):
        y, cr, cv = TMS.merge_spmv_partials(plan, torch.from_numpy(x),
                                            shape[0])
        assert int((cr == 11).sum()) >= 20
        _same(TMS.carry_out_fixup(y, cr, cv).numpy(), want)
        _same(TOPS.merge_spmv(csr, torch.from_numpy(x), plan=plan).numpy(),
              want)
