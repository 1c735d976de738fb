"""repro_torch CUDA kernels (K1–K9 and the carry step) against their plain
PyTorch versions, on the card. Every test here carries the
``cuda`` marker and skips without a CUDA device. The file imports no JAX,
so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ``max|kernel - plain| <= 1e-4 * max(1, max|plain|)`` (float32
sums in another order; the atomic adds of K3, K5, K6 and K7 in an order
that varies from run to run), as in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import coo_to_csr
from repro_torch.core.convert import ALGORITHM_SPECS
from repro_torch.data import matrices as TM
from repro_torch.kernels import _lib
from repro_torch.kernels import bsr_spmv as TBSR
from repro_torch.kernels import coo_to_tiled
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import moe_group_matmul as TK9
from repro_torch.kernels import ops as TOPS
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import (coo_to_sellcs, csr_spmm, sellcs_spmm, spmm,
                              spmm_ref)
from repro_torch.spmm.reference import sellcs_slot_x

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "python -m pytest -m cuda tests/test_torch_cuda.py")
    return torch.device("cuda")


def _close(got, want):
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


def _matrix(cuda, name="mawi_like", scale=0.05):
    return TM.as_coo(TM.test_suite(scale)[name].make(), device=cuda)


@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_kernels_match_plain(cuda, name, k):
    coo = _matrix(cuda, name)
    csr, sc = coo_to_csr(coo), coo_to_sellcs(coo)
    X = torch.randn((coo.shape[1], k), device=cuda)
    for mat, fn in ((sc, sellcs_spmm), (csr, csr_spmm)):
        _close(fn(mat, X), fn(mat, X, plain=True))
    _close(spmm(sc, X), spmm_ref(coo, X))           # auto -> kernel on cuda
    plan = TMS.cached_merge_plan(csr)
    y, cr, cv = TMS.merge_spmv_partials(plan, X[:, 0].contiguous(),
                                        coo.shape[0])
    yp, crp, cvp = TMS.merge_partials_plain(plan, X[:, :1], coo.shape[0])
    assert torch.equal(cr, crp)
    _close(y, yp[:, 0])
    _close(cv, cvp[:, 0])
    _close(TOPS.merge_spmv(csr, X[:, 0]), spmm_ref(coo, X[:, 0]))


def test_launch_counters_count_kernel_launches_only(cuda):
    coo = _matrix(cuda, "hhh_like", 0.05)
    sc = coo_to_sellcs(coo)
    X = torch.randn((coo.shape[1], 4), device=cuda)
    before = TK.sellcs_slots.launches
    sellcs_spmm(sc, X, plain=True)
    assert TK.sellcs_slots.launches == before
    sellcs_spmm(sc, X)
    assert TK.sellcs_slots.launches == before + 1


@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_transpose_kernel_matches_plain(cuda, name, k):
    """K3 against its plain version on the same slot-ordered X, and the
    whole A^T X multiply (gather + K3) against the oracle. Atomic adds:
    the order, and so the last bits, vary from run to run."""
    coo = _matrix(cuda, name)
    sc = coo_to_sellcs(coo)
    m, n = coo.shape
    X = torch.randn((m, k), device=cuda)
    xs = sellcs_slot_x(sc.row_perm, X, m)
    args = (sc.data, sc.cols, sc.slice_of, sc.slice_ptr, sc.row_len, xs)
    got = TK.sellcs_slots_t(*args, n_out=n, chunk=sc.chunk)
    assert got.shape == (n, k) and got.dtype == torch.float32
    _close(got, TK.sellcs_slots_t_plain(*args, n_out=n, chunk=sc.chunk))
    _close(sellcs_spmm(sc, X, op="T"), spmm_ref(coo, X, op="T"))
    _close(spmm(sc, X[:, 0], op="T"), spmm_ref(coo, X[:, 0], op="T"))


def test_symmetric_combine_matches_oracle(cuda):
    """One-triangle storage: K1 + unpermute + K3 - diag·X equals the
    oracle of the full matrix for both ops."""
    r, c, v, shape = TM.test_suite(0.05)["road_like"].make()
    full = TM.as_coo((np.concatenate([r, c]), np.concatenate([c, r]),
                      np.concatenate([v, v]), shape), device=cuda)
    sym = coo_to_sellcs(full, structure="symmetric")
    X = torch.randn((shape[0], 8), device=cuda)
    want = spmm_ref(full, X)
    for op in ("N", "T"):
        _close(sellcs_spmm(sym, X, op=op), want)
        _close(sellcs_spmm(sym, X, op=op, plain=True), want)


def test_cuda_tensor_launches_transpose_kernel(cuda):
    """A CUDA tensor launches K3 (the counter rises; there is no plain
    fallback), through the dispatcher, the operator's transpose and the
    backward pass of sparse_matmul; plain=True launches nothing."""
    from repro_torch.core import PlanSpec
    from repro_torch.spmm import SparseOperator, sparse_matmul
    coo = _matrix(cuda, "hhh_like")
    sc = coo_to_sellcs(coo)
    X = torch.randn((coo.shape[0], 4), device=cuda)
    before = TK.sellcs_slots_t.launches
    sellcs_spmm(sc, X, op="T", plain=True)
    assert TK.sellcs_slots_t.launches == before
    spmm(sc, X, op="T")
    assert TK.sellcs_slots_t.launches == before + 1
    op = SparseOperator.from_coo(coo, PlanSpec(num_devices=1,
                                               algorithm="sellcs"))
    assert op.plan.impl == "kernel"
    op.T @ X
    assert TK.sellcs_slots_t.launches == before + 2
    x = torch.randn((coo.shape[1], 4), device=cuda, requires_grad=True)
    k1 = TK.sellcs_slots.launches
    (g,) = torch.autograd.grad(sparse_matmul(op, x).sum(), x)
    assert TK.sellcs_slots.launches == k1 + 1
    assert TK.sellcs_slots_t.launches == before + 3
    _close(g, spmm_ref(coo, torch.ones((coo.shape[0], 4), device=cuda),
                       op="T"))


def test_wrappers_validate_operands(cuda):
    data = torch.zeros((4, 8), device=cuda)
    cols = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    ptr = torch.tensor([0, 4], dtype=torch.int32, device=cuda)
    x = torch.zeros((8, 2), device=cuda)
    with pytest.raises(TypeError):
        TK.sellcs_slots(data, cols, ptr, x, num_slices=1, chunk=8)
    with pytest.raises(ValueError):
        TK.sellcs_slots(data, cols.int(), ptr, x.t(), num_slices=1, chunk=8)
    with pytest.raises(ValueError):
        spmm(sc_cpu(), torch.zeros((64, 1)), impl="kernel")


def sc_cpu():
    coo = TM.as_coo(TM.test_suite(0.001)["hhh_like"].make(), device="cpu")
    return coo_to_sellcs(coo)


def test_rows_spanning_many_spans(cuda):
    """One dense row crossing dozens of merge spans (the carry step)."""
    m = n = 4000
    rows = np.concatenate([np.full(n, 11), np.arange(m)])
    cols = np.concatenate([np.arange(n), np.arange(m)])
    vals = np.random.default_rng(0).standard_normal(rows.size).astype(
        np.float32)
    coo = TM.as_coo((rows, cols, vals, (m, n)), device=cuda)
    csr = coo_to_csr(coo)
    X = torch.randn((n, 3), device=cuda)
    _close(csr_spmm(csr, X, num_spans=200), spmm_ref(coo, X))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("algo", ["mergeb", "csb", "bcohch"])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_tiled_kernels_match_plain(cuda, name, algo, dtype):
    """K5, K6 (default and a narrower column tile) and K7 against their
    plain versions on row-, Morton- and Hilbert-ordered tile streams, f32
    and bf16 tiles, and the f32 ones against the triplet oracle."""
    coo = _matrix(cuda, name)
    ts = coo_to_tiled(coo, algo, dtype=dtype,
                      num_bands=4 if algo == "bcohch" else 0)
    n = coo.shape[1]
    x = torch.randn(n, device=cuda)
    _close(TBSR.bsr_spmv(ts, x), TBSR.bsr_spmv_plain(ts, x))
    for k in (1, 8, 33):
        X = torch.randn((n, k), device=cuda)
        _close(TBSR.bsr_spmm(ts, X), TBSR.bsr_spmm_plain(ts, X))
        for kt in {None, max(k // 4, 1)}:
            _close(TK.tiled_spmm(ts, X, k_tile=kt),
                   TK.tiled_spmm_plain(ts, X))
        if dtype == torch.float32:
            _close(spmm(ts, X), spmm_ref(coo, X))
    if dtype == torch.float32:
        _close(TOPS.bsr_spmv(ts, x), spmm_ref(coo, x))


def test_tiled_launch_counters_and_ragged_edges(cuda):
    """Each tiled wrapper counts its own launches (plain runs count none);
    shapes that are not multiples of 8 x 128 read no X past n and write
    no row past m."""
    rng = np.random.default_rng(3)
    m, n = 1001, 777
    rows = rng.integers(0, m, 5000)
    cols = rng.integers(0, n, 5000)
    coo = TM.as_coo((rows, cols, rng.standard_normal(5000).astype(
        np.float32), (m, n)), device=cuda)
    ts = coo_to_tiled(coo, "csbh")
    X = torch.randn((n, 5), device=cuda)
    counts = (TBSR.bsr_spmv.launches, TBSR.bsr_spmm.launches,
              TK.tiled_spmm.launches)
    TOPS.bsr_spmv(ts, X[:, 0], plain=True)
    TK.tiled_spmm(ts, X, plain=True)
    assert (TBSR.bsr_spmv.launches, TBSR.bsr_spmm.launches,
            TK.tiled_spmm.launches) == counts
    _close(TOPS.bsr_spmv(ts, X[:, 1]), spmm_ref(coo, X[:, 1]))
    _close(TOPS.bsr_spmm(ts, X), spmm_ref(coo, X))
    _close(spmm(ts, X, k_tile=2), spmm_ref(coo, X))
    assert (TBSR.bsr_spmv.launches, TBSR.bsr_spmm.launches,
            TK.tiled_spmm.launches) == tuple(c + 1 for c in counts)
    with pytest.raises(ValueError):
        TK.tiled_spmm(ts, X, k_tile=6)


@pytest.mark.parametrize("k", [1, 8, 33])
@pytest.mark.parametrize("name", ["mawi_like", "road_like"])
def test_fused_gather_kernel_matches_plain_and_upfront(cuda, name, k):
    """K8 against its plain version, and bitwise equal to K1 over the
    up-front slab ``x[col_map]`` (the adds per slot keep K1's order)."""
    from repro_torch.spmm import distributed as TD
    coo = _matrix(cuda, name)
    part = TD.partition_sellcs_rows(coo_to_sellcs(coo), 3, compact_x=True)
    X = torch.randn((coo.shape[1], k), device=cuda)
    for sh in part.shards:
        if sh.width_rows == 0:
            continue
        kw = dict(num_slices=sh.num_slices, chunk=part.chunk)
        fused = TK.sellcs_slots(sh.data, sh.cols, sh.slice_ptr, X,
                                col_map=sh.col_map, **kw)
        _close(fused, TK.sellcs_slots_plain(sh.data, sh.cols, sh.slice_ptr,
                                            X, col_map=sh.col_map, **kw))
        slab = X.index_select(0, sh.col_map)
        assert torch.equal(fused, TK.sellcs_slots(sh.data, sh.cols,
                                                  sh.slice_ptr, slab, **kw))


def test_fused_gather_counter_and_mesh_on_one_card(cuda):
    """K8 counts in its own counter; the mesh multiplies on four shards of
    one card agree with the oracle, and their gather modes bitwise."""
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.spmm import distributed as TD
    coo = _matrix(cuda, "hhh_like", 0.05)
    sc = coo_to_sellcs(coo)
    mesh = make_spmm_mesh((4, 1), devices=["cuda:0"] * 4)
    X = torch.randn((coo.shape[1], 8), device=cuda)
    ref = spmm_ref(coo, X)
    for part in (TD.partition_sellcs_rows(sc, 4, compact_x=True),
                 TD.partition_sellcs_nnz(sc, 4, num_chunks=3,
                                         compact_x=True)):
        fn = (TD.spmm_row_distributed if part.schedule == "row"
              else TD.spmm_merge_distributed)
        kw = {} if part.schedule == "row" else {"num_chunks": 3}
        before = (TK.sellcs_slots.launches, TK.sellcs_slots.fused_launches)
        up = fn(part, X, mesh, gather="upfront", **kw)
        mid = (TK.sellcs_slots.launches, TK.sellcs_slots.fused_launches)
        fused = fn(part, X, mesh, gather="fused", **kw)
        after = (TK.sellcs_slots.launches, TK.sellcs_slots.fused_launches)
        assert mid[0] > before[0] and mid[1] == before[1]
        assert after[1] > mid[1] and after[0] == mid[0]
        assert torch.equal(up, fused)
        _close(up, ref)
        Xt = torch.randn((coo.shape[0], 8), device=cuda)
        _close(fn(part, Xt, mesh, op="T", **kw), spmm_ref(coo, Xt, op="T"))


def _k9_operands(cuda, case):
    """(tokens, weights, group sizes) of a K9 case: granite's decode shape
    (256 slots over 32 experts, skewed, bf16 tokens), the reference
    test's group sizes with empty groups (bf16), or f32 at granite's
    reduced widths (K = N = 64, padded to 128)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    if case == "decode":
        T, K, N, E, dt = 256, 1024, 512, 32, torch.bfloat16
        skew = 1.0 / torch.arange(1, E + 1, device=cuda) ** 1.2
        experts = torch.multinomial(skew, T, replacement=True,
                                    generator=gen)
        sizes = torch.bincount(experts, minlength=E)
    elif case == "empty_groups":
        T, K, N, E, dt = 300, 256, 384, 4, torch.bfloat16
        sizes = torch.tensor([10, 200, 0, 90], device=cuda)
    else:
        T, K, N, E, dt = 64, 64, 64, 8, torch.float32
        sizes = torch.tensor([0, 20, 0, 0, 30, 14, 0, 0], device=cuda)
    tokens = torch.randn((T, K), generator=gen, device=cuda).to(dt)
    w = torch.randn((E, K, N), generator=gen, device=cuda) * K ** -0.5
    return tokens, w, sizes


def _k9_launches():
    return (TK9.moe_group_matmul_padded.launches,
            TK9.moe_group_matmul_decode.launches,
            TK9.moe_group_matmul_wgmma.launches)


@pytest.mark.parametrize("case", ["decode", "empty_groups", "f32_reduced"])
def test_grouped_gemm_kernel_matches_plain(cuda, case):
    """``ops.moe_group_matmul`` launches one K9 kernel, the one its route
    takes from the shapes and the tokens' dtype (the tensor-core kernel
    for bf16 tokens; for f32 the decode kernel when few rows fall to an
    expert, else the tiled one), against the plain version;
    ``plain=True`` launches nothing."""
    tokens, w, sizes = _k9_operands(cuda, case)
    decode = TOPS.takes_decode_kernel(tokens.shape[0], w.shape[0],
                                      tokens.dtype)
    wgmma = tokens.dtype == torch.bfloat16
    tiled0, dec0, wg0 = _k9_launches()
    got = TOPS.moe_group_matmul(tokens, w, sizes)
    want_counts = (tiled0 + (not decode and not wgmma), dec0 + decode,
                   wg0 + wgmma)
    assert _k9_launches() == want_counts
    want = TOPS.moe_group_matmul(tokens, w, sizes, plain=True)
    assert _k9_launches() == want_counts
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    # the padded layer: tiles past the real length are zero
    E, Kp = w.shape[0], -(-w.shape[1] // 128) * 128
    wp = torch.nn.functional.pad(w, (0, -w.shape[2] % 128,
                                     0, Kp - w.shape[1])).contiguous()
    gp = TOPS.moe_group_pad(tokens, sizes, E, Kp)
    out = TK9.moe_group_matmul_padded(gp.lhs, wp, gp.tile_expert,
                                      n_rows=gp.n_rows)
    _close(out, TK9.moe_group_matmul_padded_plain(
        gp.lhs, wp, gp.tile_expert, n_rows=gp.n_rows))
    assert float(out[int(gp.n_rows):].abs().max()) == 0.0


def test_grouped_gemm_wrapper_validates_operands(cuda):
    lhs = torch.zeros((256, 128), device=cuda)
    w = torch.zeros((2, 128, 128), device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        TK9.moe_group_matmul_padded(lhs.half(), w, te)
    with pytest.raises(TypeError):
        TK9.moe_group_matmul_padded(lhs, w.double(), te)
    with pytest.raises(TypeError):
        TK9.moe_group_matmul_padded(lhs, w, te, out_dtype=torch.int32)
    with pytest.raises(ValueError):          # one expert id per m-tile
        TK9.moe_group_matmul_padded(lhs, w, te[:1])
    with pytest.raises(ValueError):          # not contiguous
        TK9.moe_group_matmul_padded(
            torch.zeros((128, 256), device=cuda).t(), w, te)
    with pytest.raises(ValueError):          # on another device
        TK9.moe_group_matmul_padded(lhs, w.cpu(), te)


@pytest.mark.parametrize("case", ["out_bf16", "rhs_bf16"])
def test_grouped_gemm_takes_the_reference_dtypes(cuda, case):
    """K9 with a bf16 output (its f32 answer cast once) and with bf16
    weights (widened to f32 exactly) against its plain version."""
    tokens, w, sizes = _k9_operands(cuda, "decode")
    E, K = w.shape[0], w.shape[1]
    gp = TOPS.moe_group_pad(tokens, sizes, E, K)
    kw = {"out_dtype": torch.bfloat16} if case == "out_bf16" else {}
    if case == "rhs_bf16":
        w = w.to(torch.bfloat16)
    before = TK9.moe_group_matmul_padded.launches
    got = TK9.moe_group_matmul_padded(gp.lhs, w, gp.tile_expert,
                                      n_rows=gp.n_rows, **kw)
    assert TK9.moe_group_matmul_padded.launches == before + 1
    want = TK9.moe_group_matmul_padded_plain(
        gp.lhs, w, gp.tile_expert, n_rows=gp.n_rows)
    assert got.dtype == (torch.bfloat16 if case == "out_bf16"
                         else torch.float32)
    if case == "out_bf16":
        # one bf16 step of the largest output: f32 sums in another order
        # may round to the neighbouring bf16 value
        step = 2.0 ** -7 * max(1.0, float(want.abs().max()))
        assert float((got.float() - want).abs().max()) <= step
    else:
        _close(got, want)


def test_grouped_gemm_past_65535_m_tiles(cuda):
    """One launch over 65,536 m-tiles (K = N = 128): the m-tiles are on
    grid.x, so the old 65,535-tile cap is gone; the last tiles against
    the plain version."""
    nm = 65536
    gen = torch.Generator(device=cuda).manual_seed(9)
    lhs = torch.randn((nm * 128, 128), generator=gen, device=cuda).to(
        torch.bfloat16)
    w = torch.randn((4, 128, 128), generator=gen, device=cuda) / 16
    te = torch.arange(nm, device=cuda, dtype=torch.int32) % 4
    out = TK9.moe_group_matmul_padded(lhs, w, te)
    torch.cuda.synchronize()
    tail = slice((nm - 3) * 128, nm * 128)
    _close(out[tail], TK9.moe_group_matmul_padded_plain(
        lhs[tail].contiguous(), w, te[nm - 3:].contiguous()))
    _close(out[:128], lhs[:128].float() @ w[0])


def _tiled(cuda, tiles, rows, cols, shape, dtype=torch.float32):
    from repro_torch.kernels.tiling import TiledSparse
    tiles = torch.as_tensor(tiles, dtype=torch.float32).to(dtype)
    nnz = int((tiles != 0).sum())
    return TiledSparse(tiles.to(cuda).contiguous(),
                       torch.as_tensor(rows, dtype=torch.int32).to(cuda),
                       torch.as_tensor(cols, dtype=torch.int32).to(cuda),
                       shape, 0, "csb", nnz)


def _same_places_close(got, want):
    """NaN and Inf at the same places, the finite values within the
    tolerance of the finite ones."""
    tol = 1e-4 * max(1.0, float(want[want.isfinite()].abs().max())
                     if bool(want.isfinite().any()) else 1.0)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    fin = want.isfinite()
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0
    assert err <= tol, (err, tol)


def _k67_close(ts, X, kts):
    """K7 and K6 (each column tile in ``kts``) against their plain
    versions, each launch counted once; NaN and Inf must match."""
    want = TBSR.bsr_spmm_plain(ts, X)
    runs = [(TBSR.bsr_spmm, lambda: TBSR.bsr_spmm(ts, X))]
    runs += [(TK.tiled_spmm, (lambda kt=kt: TK.tiled_spmm(ts, X, k_tile=kt)))
             for kt in kts]
    for wrapper, run in runs:
        before = wrapper.launches
        got = run()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _same_places_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 31, 32, 33, 96, 129])
def test_tiled_spmm_skips_zeros_matches_plain(cuda, k, dtype):
    """The redesigned K6/K7 (stored zeros skipped, persistent grid, tile
    ring) against the plain versions on a road_like stream, every k of a
    lane-share, one-pass, several-pass and several-sweep schedule, with
    kt = k and a narrower column tile."""
    coo = _matrix(cuda, "road_like", 0.05)
    ts = coo_to_tiled(coo, "csb", dtype=dtype)
    X = torch.randn((coo.shape[1], k), device=cuda)
    _k67_close(ts, X, sorted({k, max(k // 3, 1)}))


def test_tiled_spmm_edge_streams(cuda):
    """An all-zero tile, an empty stream, a tile row longer than a block's
    range (200 tiles of one dense row), alternating tile rows and a dense
    tile, against the plain versions."""
    rng = np.random.default_rng(4)
    # one all-zero tile beside two sparse ones
    t = np.zeros((3, 8, 128), np.float32)
    t[1, 3, 5], t[2, 0, 127], t[2, 7, 0] = 2.0, -1.0, 3.0
    ts = _tiled(cuda, t, [0, 1, 1], [0, 0, 1], (16, 256))
    _k67_close(ts, torch.randn((256, 40), device=cuda), [40, 7])
    # the empty stream: Y is zero
    ts = _tiled(cuda, np.zeros((0, 8, 128), np.float32), [], [], (16, 256))
    X = torch.randn((256, 5), device=cuda)
    for y in (TBSR.bsr_spmm(ts, X), TK.tiled_spmm(ts, X, k_tile=2)):
        assert y.shape == (16, 5) and float(y.abs().max()) == 0.0
    # a dense row (row 3 of tile row 2) over 200 tile columns
    n = 128 * 200
    t = np.zeros((200, 8, 128), np.float32)
    t[:, 3, :] = rng.standard_normal((200, 128))
    t[::7, 5, ::9] = 1.0
    ts = _tiled(cuda, t, np.full(200, 2), np.arange(200), (24, n))
    for k in (1, 32, 33):
        _k67_close(ts, torch.randn((n, k), device=cuda), [k])
    # tile rows alternating 0, 1, 0, 1, ... over 100 tiles, dense tiles
    t = rng.standard_normal((100, 8, 128)).astype(np.float32)
    t[rng.random(t.shape) < 0.9] = 0.0
    t[50] = rng.standard_normal((8, 128))
    ts = _tiled(cuda, t, np.arange(100) % 2, np.arange(100) % 3,
                (16, 3 * 128 - 5), torch.bfloat16)
    for k in (4, 32, 70):
        _k67_close(ts, torch.randn((3 * 128 - 5, k), device=cuda), [k, 3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_spmm_nonfinite_x_through_stored_zeros(cuda, dtype):
    """A NaN and an Inf of X in blocks where only stored zeros meet them
    reach every row of those tiles, as in the dense tile product; a
    finite f32 that rounds to Inf in bf16 does the same for bf16 tiles."""
    rows, cols, vals, (m, n) = TM.test_suite(0.05)["road_like"].make()
    # three columns emptied: their X rows meet stored zeros only
    q = [n // 4 + 3, n // 2 + 70, 3 * n // 4 + 127]
    keep = ~np.isin(cols, q)
    coo = TM.as_coo((rows[keep], cols[keep], vals[keep], (m, n)),
                    device=cuda)
    ts = coo_to_tiled(coo, "csb", dtype=dtype)
    for k in (1, 8, 33):
        X = torch.randn((n, k), device=cuda)
        X[q[0], 0] = float("nan")
        X[q[1], k - 1] = float("-inf")
        X[q[2], k // 2] = 3.4e38
        want = TBSR.bsr_spmm_plain(ts, X)
        assert int(want.isnan().sum()) >= 8
        _k67_close(ts, X, sorted({k, max(k // 2, 1)}))


# --------------------------------------------------------------------------
# K5 on its zero-free operand, K4's block-wide reduce-by-key
# --------------------------------------------------------------------------
BLOCKED_ORDERS = ("csb", "csbh", "bcoh", "bcohc", "bcohch", "bcohchp",
                  "mergeb", "mergebh")


def _k5_close(ts, x):
    """K5 against its plain version, its launch counted once; NaN and Inf
    must match."""
    want = TBSR.bsr_spmv_plain(ts, x)
    before = TBSR.bsr_spmv.launches
    got = TBSR.bsr_spmv(ts, x)
    torch.cuda.synchronize()
    assert TBSR.bsr_spmv.launches == before + 1
    _same_places_close(got, want)
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("algo", BLOCKED_ORDERS)
def test_k5_compact_operand_matches_plain(cuda, algo, dtype):
    """The redesigned K5 against its plain version on every blocked order,
    f32 and bf16 tiles, ragged m and n, a dense row over many chunks; then
    an X with a NaN, an Inf and a finite value that rounds to Inf in bf16,
    in columns that only stored zeros meet."""
    rng = np.random.default_rng(6)
    m, n = 3001, 2903
    q = [700, 1500, 2900]                        # columns left empty
    rows = np.concatenate([rng.integers(0, m, 20000), np.full(2500, 7)])
    cols = np.concatenate([rng.integers(0, n, 20000),
                           rng.choice(n, 2500, replace=False)])
    keep = ~np.isin(cols, q)
    coo = TM.as_coo((rows[keep], cols[keep], rng.standard_normal(
        rows.size).astype(np.float32)[keep], (m, n)), device=cuda)
    bands = 4 if ALGORITHM_SPECS[algo].scheduling == "static_rows" else 0
    ts = coo_to_tiled(coo, algo, dtype=dtype, num_bands=bands)
    x = torch.randn(n, device=cuda)
    _k5_close(ts, x)
    if dtype == torch.float32:
        _close(TOPS.bsr_spmv(ts, x), spmm_ref(coo, x))
    x[q[0]], x[q[1]], x[q[2]] = float("nan"), float("-inf"), 3.4e38
    want = _k5_close(ts, x)
    assert int(want.isnan().sum()) >= 16


def test_k5_edge_streams_and_operand_cache(cuda):
    """An all-zero tile, the empty stream, a tile row of 200 tiles (seven
    chunks), tile rows alternating inside one chunk, a dense tile; the
    operand built once per TiledSparse and rebuilt after an in-place
    change."""
    rng = np.random.default_rng(7)
    t = np.zeros((3, 8, 128), np.float32)
    t[1, 3, 5], t[2, 0, 127], t[2, 7, 0] = 2.0, -1.0, 3.0
    _k5_close(_tiled(cuda, t, [0, 1, 1], [0, 0, 1], (16, 256)),
              torch.randn(256, device=cuda))
    ts = _tiled(cuda, np.zeros((0, 8, 128), np.float32), [], [], (16, 256))
    y = TBSR.bsr_spmv(ts, torch.randn(256, device=cuda))
    assert y.shape == (16,) and float(y.abs().max()) == 0.0
    n = 128 * 200
    t = np.zeros((200, 8, 128), np.float32)
    t[:, 3, :] = rng.standard_normal((200, 128))
    t[::7, 5, ::9] = 1.0
    ts = _tiled(cuda, t, np.full(200, 2), np.arange(200), (24, n))
    _k5_close(ts, torch.randn(n, device=cuda))
    t = rng.standard_normal((100, 8, 128)).astype(np.float32)
    t[rng.random(t.shape) < 0.9] = 0.0
    t[50] = rng.standard_normal((8, 128))
    ts = _tiled(cuda, t, np.arange(100) % 2, np.arange(100) % 3,
                (16, 3 * 128 - 5), torch.bfloat16)
    x = torch.randn(3 * 128 - 5, device=cuda)
    _k5_close(ts, x)
    c = TBSR._compact_tiles(ts)
    _k5_close(ts, x)
    assert TBSR._compact_tiles(ts) is c
    ts.tiles.mul_(2)
    _k5_close(ts, x)
    assert ts._compact is not c


def test_stream_of_is_the_current_stream(cuda):
    """Every wrapper passes ``_lib.stream_of`` to its C entry: it reads
    the raw handle through a private PyTorch call, which must still exist
    and name the stream that ``torch.cuda`` calls current, also inside a
    ``torch.cuda.stream`` block and for a tensor on the current device."""
    from repro_torch.kernels import _lib
    t = torch.zeros(1, device=cuda)
    assert _lib.stream_of(t) == torch.cuda.current_stream(cuda).cuda_stream
    s = torch.cuda.Stream(cuda)
    with torch.cuda.stream(s):
        assert _lib.stream_of(t) == s.cuda_stream != 0
    assert _lib.stream_of(t) == torch.cuda.current_stream(cuda).cuda_stream


def _k4_plans(cuda):
    """The reference's merge plan carried across by interop (as the
    reference builds it: D = 39, its spans without a nonzero padded to 39
    items of local row 0) and the port's own plan of the same matrix (those
    spans empty), 203 spans; row 11 crosses more than 20 of them.
    ``tests/test_torch_spmv_redesign.py`` holds both to the reference."""
    m = n = 3000
    rng = np.random.default_rng(8)
    diag = np.r_[0:1000, 2600:3000]
    rows = np.concatenate([np.full(n, 11), diag,
                           rng.integers(2600, 3000, 500)])
    cols = np.concatenate([np.arange(n), diag, rng.integers(0, n, 500)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    coo = TM.as_coo((rows, cols, vals, (m, n)), device=cuda)
    own = TMS.merge_plan(coo_to_csr(coo), 203)
    carried = interop.merge_plan_from_arrays(
        {"cols": own.cols.cpu().numpy(), "vals": own.vals.cpu().numpy(),
         "seg": own.seg.cpu().numpy(),
         "row_starts": own.row_starts.cpu().numpy(),
         "r_width": own.r_width}, device=cuda)
    assert own.depth % 4 and bool((own.span_len == 0).any())
    assert bool((carried.span_len == carried.depth).sum() > 20)
    return coo, {"carried": carried, "own": own}


@pytest.mark.parametrize("which", ["carried", "own"])
def test_k4_reduce_by_key_matches_plain(cuda, which):
    """K4 against its plain version (carry rows equal), bitwise equal
    across two launches, and the whole SpMV against the oracle."""
    coo, plans = _k4_plans(cuda)
    plan = plans[which]
    m = coo.shape[0]
    x = torch.randn(coo.shape[1], device=cuda)
    before = TMS.merge_spmv_partials.launches
    got = TMS.merge_spmv_partials(plan, x, m)
    again = TMS.merge_spmv_partials(plan, x, m)
    torch.cuda.synchronize()
    assert TMS.merge_spmv_partials.launches == before + 2
    y, cr, cv = TMS.merge_partials_plain(plan, x[:, None], m)
    assert torch.equal(got[1], cr) and int((cr == 11).sum()) >= 20
    _close(got[0], y[:, 0])
    _close(got[2], cv[:, 0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    full = TMS.carry_out_fixup(got[0].clone(), got[1], got[2])
    _close(full, spmm_ref(coo, x))


@pytest.mark.parametrize("k", [8, 33])
def test_k2_unchanged_on_the_carried_plan(cuda, k):
    """K2 keeps its own kernel: against its plain version on both plans."""
    coo, plans = _k4_plans(cuda)
    X = torch.randn((coo.shape[1], k), device=cuda)
    for plan in plans.values():
        got = TK._merge_spmm_partials(plan, X, coo.shape[0])
        y, cr, cv = TMS.merge_partials_plain(plan, X, coo.shape[0])
        assert torch.equal(got[1], cr)
        _close(got[0], y)
        _close(got[2], cv)


@pytest.mark.parametrize("name", ["hhh_like", "mawi_like", "road_like"])
def test_k4_matches_plain_on_the_suite(cuda, name):
    """K4 at the suite's shapes, its default span count, and a deep one."""
    coo = _matrix(cuda, name, 0.2)
    csr = coo_to_csr(coo)
    x = torch.randn(coo.shape[1], device=cuda)
    for spans in (None, 16):
        plan = TMS.cached_merge_plan(csr, spans)
        got = TMS.merge_spmv_partials(plan, x, coo.shape[0])
        y, cr, cv = TMS.merge_partials_plain(plan, x[:, None], coo.shape[0])
        assert torch.equal(got[1], cr)
        _close(got[0], y[:, 0])
        _close(got[2], cv[:, 0])
    _close(TOPS.merge_spmv(csr, x), spmm_ref(coo, x))


def test_moe_layer_kernel_route_matches_plain(cuda):
    """One granite MoE layer (d 1024, d_ff 512, 32 experts, top-8) on f32
    activations: K9 against its plain version through moe_apply, and the
    per-expert route."""
    from repro_torch.models import moe as TMOE
    cfg = TMOE.MoEConfig(1024, 512, 32, 8, use_kernel=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = TMOE.moe_init(gen, cfg)
    x = torch.randn((2, 64, 1024), generator=gen, device=cuda)
    before = sum(_k9_launches())
    out, aux = TMOE.moe_apply(p, cfg, x)
    assert sum(_k9_launches()) == before + 3
    plain, aux_p = TMOE.moe_apply(p, cfg._replace(plain=True), x)
    ragged, _ = TMOE.moe_apply(p, cfg._replace(use_kernel=False), x)
    assert sum(_k9_launches()) == before + 3
    _close(out, plain)
    _close(out, ragged)
    assert float(aux) == float(aux_p)


# --------------------------------------------------------------------------
# K3 redesigned (warp per lane group, x in registers, column bands)
# --------------------------------------------------------------------------
def _k3_close(sc_arrays, xs, n_out, chunk):
    got = TK.sellcs_slots_t(*sc_arrays, xs, n_out=n_out, chunk=chunk)
    assert got.shape == (n_out, xs.shape[1]) and got.dtype == torch.float32
    _close(got, TK.sellcs_slots_t_plain(*sc_arrays, xs, n_out=n_out,
                                        chunk=chunk))


def _deep_coo(cuda):
    """Row 5 holds 3,000 entries (a slice ~188 of K3's 16-deep chunks
    deep), sparse rows around it, rows 128..383 empty (two empty slices
    at C = 128)."""
    r = np.random.default_rng(5)
    m, n = 1024, 4000
    rows = np.concatenate([np.full(3000, 5), r.integers(0, 128, 2000),
                           r.integers(384, m, 6000)])
    cols = np.concatenate([r.permutation(n)[:3000],
                           r.integers(0, n, 8000)])
    keys = np.unique(rows * n + cols)
    return TM.as_coo(((keys // n).astype(np.int32),
                      (keys % n).astype(np.int32),
                      r.standard_normal(keys.size).astype(np.float32),
                      (m, n)), device=cuda)


@pytest.mark.parametrize("k", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("case", ["deep", "mawi_like", "chunk_16"])
def test_k3_matches_plain_at_every_width(cuda, case, k):
    """K3 against its plain version: a slice thousands of width-rows deep
    with empty slices, the suite's mawi_like, and a slice height of 16
    (a partial lane group)."""
    if case == "deep":
        coo, c = _deep_coo(cuda), 128
    else:
        coo, c = _matrix(cuda, "mawi_like"), (16 if case == "chunk_16"
                                             else 128)
    sc = coo_to_sellcs(coo, c=c)
    if case == "deep":
        widths = sc.slice_ptr[1:] - sc.slice_ptr[:-1]
        assert int(widths.max()) >= 3000 and int((widths == 0).sum()) >= 2
    m, n = coo.shape
    xs = sellcs_slot_x(sc.row_perm, torch.randn((m, k), device=cuda), m)
    _k3_close((sc.data, sc.cols, sc.slice_of, sc.slice_ptr, sc.row_len),
              xs, n, sc.chunk)


@pytest.mark.parametrize("label", ["row", "merge"])
def test_k3_matches_plain_on_mesh_shards(cuda, label):
    """K3 on the shard arrays of the mesh partitioners (a merge span
    starts and ends mid-slice: a negative depth base), and the mesh
    transpose against the oracle."""
    from repro_torch.launch.mesh import make_spmm_mesh
    from repro_torch.spmm import distributed as TD
    coo = _matrix(cuda, "hhh_like", 0.05)
    sc = coo_to_sellcs(coo)
    part = (TD.partition_sellcs_rows(sc, 4) if label == "row"
            else TD.partition_sellcs_nnz(sc, 4, num_chunks=4))
    m, n = coo.shape
    X = torch.randn((m, 8), device=cuda)
    xs = sellcs_slot_x(sc.row_perm, X, m)
    C = sc.chunk
    for sh in part.shards:
        if sh.data.shape[0] == 0:
            continue
        win = xs[sh.t_first * C:(sh.t_first + sh.t_ptr.shape[0] - 1) * C]
        _k3_close((sh.data, sh.cols, sh.t_ids, sh.t_ptr, sh.t_row_len),
                  win, n, C)
    mesh = make_spmm_mesh((4, 1), devices=["cuda:0"] * 4)
    fn = (TD.spmm_row_distributed if label == "row"
          else lambda *a, **kw: TD.spmm_merge_distributed(
              *a, num_chunks=4, **kw))
    _close(fn(part, X, mesh, op="T"), spmm_ref(coo, X, op="T"))


def test_k3_column_bands(cuda, monkeypatch):
    """A small L2 forces K3 into several column passes: one launch of the
    wrapper, the same answer."""
    from repro_torch.kernels import _lib
    coo = _matrix(cuda, "hhh_like", 0.05)
    sc = coo_to_sellcs(coo)
    m, n = coo.shape
    xs = sellcs_slot_x(sc.row_perm, torch.randn((m, 32), device=cuda), m)
    # two thirds of this "L2" hold a quarter of the f32 [n, 32] Y
    monkeypatch.setattr(_lib, "l2_bytes", lambda dev: 3 * 4 * n * 32 // 8)
    assert TK.column_bands(n, 32, _lib.l2_bytes(cuda)) == 4
    before = TK.sellcs_slots_t.launches
    _k3_close((sc.data, sc.cols, sc.slice_of, sc.slice_ptr, sc.row_len),
              xs, n, sc.chunk)
    assert TK.sellcs_slots_t.launches == before + 1


# --------------------------------------------------------------------------
# K9's decode kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["skewed", "groups_of_32", "empty_groups",
                                  "deep_group"])
def test_k9_decode_kernel_equals_tiled_bitwise(cuda, case, dtype):
    """The decode kernel against the tiled kernel with ``torch.equal``
    (both given the tiles' row counts, and on the live rows without
    them) and against the plain version: a skewed decode step, eight
    groups of exactly 32 rows, empty groups, and a group of 300 rows (a
    full tile and tiles of more than 32 rows: several passes)."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    E, K, N = 32, 1024, 512
    if case == "skewed":
        skew = 1.0 / torch.arange(1, E + 1, device=cuda) ** 1.2
        sizes = torch.bincount(torch.multinomial(
            skew, 256, replacement=True, generator=gen), minlength=E)
    else:
        sizes = torch.zeros(E, dtype=torch.int64, device=cuda)
        if case == "groups_of_32":
            sizes[:8] = 32
        elif case == "empty_groups":
            sizes[[1, 4, 9, 30]] = torch.tensor([20, 1, 7, 31], device=cuda)
        else:
            sizes[[0, 3]] = torch.tensor([300, 17], device=cuda)
    tokens = torch.randn((int(sizes.sum()), K), generator=gen,
                         device=cuda).to(dtype)
    w = torch.randn((E, K, N), generator=gen, device=cuda) * K ** -0.5
    gp = TOPS.moe_group_pad(tokens, sizes, E, K)
    args = (gp.lhs, w, gp.tile_expert)
    before = TK9.moe_group_matmul_decode.launches
    dec = TK9.moe_group_matmul_decode(*args, gp.tile_rows, n_rows=gp.n_rows)
    assert TK9.moe_group_matmul_decode.launches == before + 1
    tiled = TK9.moe_group_matmul_padded(*args, n_rows=gp.n_rows,
                                        tile_rows=gp.tile_rows)
    assert torch.equal(dec, tiled)
    live = (torch.arange(128, device=cuda)[None, :]
            < gp.tile_rows[:, None]).reshape(-1)
    assert torch.equal(dec[live], TK9.moe_group_matmul_padded(
        *args, n_rows=gp.n_rows)[live])
    assert float(dec[~live].abs().max()) == 0.0
    _close(dec, TK9.moe_group_matmul_padded_plain(
        *args, n_rows=gp.n_rows, tile_rows=gp.tile_rows))
    # without n_rows the tiles past the real length are empty by count
    assert torch.equal(TK9.moe_group_matmul_decode(*args, gp.tile_rows),
                       dec)


def test_k9_decode_wrapper_validates_operands(cuda):
    lhs = torch.zeros((256, 128), device=cuda)
    w = torch.zeros((2, 128, 128), device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    tr = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        TK9.moe_group_matmul_decode(lhs, w, te, tr[:1])
    with pytest.raises(TypeError):
        TK9.moe_group_matmul_decode(lhs, w, te, tr.long())
    with pytest.raises(ValueError):
        TK9.moe_group_matmul_decode(lhs, w, te, tr.cpu())


# --------------------------------------------------------------------------
# K2 redesigned (chains of S lanes, staged indices, gathers in flight)
# --------------------------------------------------------------------------
def _k2_case(cuda, case):
    """(matrix, plan) of a K2 case: a suite matrix at small scale with its
    default span count, or ``_k4_plans``' carried and own plans (empty
    spans, one-row spans, row 11 across more than 20 spans)."""
    if case in ("carried", "own"):
        coo, plans = _k4_plans(cuda)
        return coo, plans[case]
    coo = _matrix(cuda, case, 0.2)
    return coo, TMS.cached_merge_plan(coo_to_csr(coo))


@pytest.mark.parametrize("k", [2, 3, 8, 16, 32, 33, 64])
@pytest.mark.parametrize("case", ["hhh_like", "mawi_like", "road_like",
                                  "carried", "own"])
def test_k2_matches_plain_at_every_width(cuda, case, k):
    """K2 against its plain version at every lane layout (float4 columns
    for k % 4 == 0, one column a lane else; passes for k > 32 columns),
    the carry rows equal, two launches bitwise equal, and the whole
    multiply (K2 + carry step) against the oracle."""
    coo, plan = _k2_case(cuda, case)
    m = coo.shape[0]
    X = torch.randn((coo.shape[1], k), device=cuda)
    before = TK._merge_spmm_partials.launches
    got = TK._merge_spmm_partials(plan, X, m)
    again = TK._merge_spmm_partials(plan, X, m)
    torch.cuda.synchronize()
    assert TK._merge_spmm_partials.launches == before + 2
    y, cr, cv = TMS.merge_partials_plain(plan, X, m)
    assert torch.equal(got[1], cr)
    _close(got[0], y)
    _close(got[2], cv)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    full = TMS.carry_out_fixup(got[0].clone(), got[1], got[2])
    _close(full, spmm_ref(coo, X))


# --------------------------------------------------------------------------
# the merge multiply from one C entry call: the memset of Y, K4 or K2, and
# the carry step launched as its programmatic dependent
# --------------------------------------------------------------------------
def _merge_case(cuda, case):
    """The dense-row matrix of ``test_rows_spanning_many_spans`` at 200
    spans (row 11 across dozens of them), or a suite matrix at its default
    span count."""
    if case == "dense_row":
        m = n = 4000
        rows = np.concatenate([np.full(n, 11), np.arange(m)])
        cols = np.concatenate([np.arange(n), np.arange(m)])
        vals = np.random.default_rng(0).standard_normal(rows.size).astype(
            np.float32)
        coo = TM.as_coo((rows, cols, vals, (m, n)), device=cuda)
        csr = coo_to_csr(coo)
        return coo, csr, TMS.cached_merge_plan(csr, 200)
    coo = _matrix(cuda, case, 0.2)
    csr = coo_to_csr(coo)
    return coo, csr, TMS.cached_merge_plan(csr)


def _entry_calls(monkeypatch):
    """The names of the C entry points called from here on."""
    names, real = [], _lib.entry

    def entry(fn):
        names.append(fn)
        return real(fn)
    monkeypatch.setattr(_lib, "entry", entry)
    return names


@pytest.mark.parametrize("k", [1, 8, 32, 33])
@pytest.mark.parametrize("case", ["dense_row", "hhh_like", "mawi_like"])
def test_fused_merge_multiply_one_call_bitwise_two_call_path(
        cuda, monkeypatch, case, k):
    """``csr_spmm`` (and ``kernels.ops.merge_spmv`` at k = 1) make one C
    entry call, count one launch of each kernel, give the same bits as the
    partials wrapper followed by the standalone carry step and as a second
    call, and agree with the plain version and the oracle."""
    coo, csr, plan = _merge_case(cuda, case)
    m = coo.shape[0]
    X = torch.randn((coo.shape[1], k), device=cuda)
    names = _entry_calls(monkeypatch)
    counts = (TK.merge_spmm_fused.calls, TK._merge_spmm_partials.launches,
              TMS.carry_out_fixup.launches)
    got = csr_spmm(csr, X, plan=plan)
    assert names == ["merge_spmm_launch"]
    assert (TK.merge_spmm_fused.calls, TK._merge_spmm_partials.launches,
            TMS.carry_out_fixup.launches) == tuple(c + 1 for c in counts)
    again = csr_spmm(csr, X, plan=plan)
    two = TMS.carry_out_fixup(*TK._merge_spmm_partials(plan, X, m))
    torch.cuda.synchronize()
    assert torch.equal(got, two) and torch.equal(got, again)
    y, cr, cv = TMS.merge_partials_plain(plan, X, m)
    _close(got, TMS.carry_out_fixup_plain(y, cr, cv))
    _close(got, spmm_ref(coo, X))
    if k != 1:
        return
    x = X[:, 0].contiguous()
    names.clear()
    counts = (TMS.merge_spmv_fused.calls, TMS.merge_spmv_partials.launches,
              TMS.carry_out_fixup.launches)
    got = TOPS.merge_spmv(csr, x, plan=plan)
    assert names == ["merge_spmv_launch"]
    assert (TMS.merge_spmv_fused.calls, TMS.merge_spmv_partials.launches,
            TMS.carry_out_fixup.launches) == tuple(c + 1 for c in counts)
    again = TOPS.merge_spmv(csr, x, plan=plan)
    two = TMS.carry_out_fixup(*TMS.merge_spmv_partials(plan, x, m))
    torch.cuda.synchronize()
    assert torch.equal(got, two) and torch.equal(got, again)
    y, cr, cv = TMS.merge_partials_plain(plan, x[:, None], m)
    _close(got, TMS.carry_out_fixup_plain(y, cr, cv)[:, 0])


@pytest.mark.parametrize("k", [1, 8, 32, 33])
def test_carry_step_on_long_runs_with_empty_spans(cuda, k):
    """The standalone carry step on carries with one row across 300 spans
    that holds empty spans ((-1, -1) pairs) inside its run, runs ending at
    every offset of a step and a run reaching the last entry: against its
    plain version, two launches bitwise equal."""
    rows, r = [0, 1], 1
    for i in range(300):
        rows += [-1, -1] if i % 29 == 3 else [r, -1]
    for length in range(1, 40):
        r += 1
        rows += [r, -1] * length + [r, r + 1]
        r += 1
    rows += [r] * 64
    carry_row = torch.tensor(rows, dtype=torch.int32, device=cuda)
    carry_val = torch.randn((len(rows), k), device=cuda)
    carry_val[carry_row < 0] = 0
    y0 = torch.randn((r + 1, k), device=cuda)
    got = TMS.carry_out_fixup(y0.clone(), carry_row, carry_val)
    again = TMS.carry_out_fixup(y0.clone(), carry_row, carry_val)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, TMS.carry_out_fixup_plain(y0.clone(), carry_row, carry_val))


# --------------------------------------------------------------------------
# K9's tensor-core kernel (bf16 rows, f32 weights split into three terms)
# --------------------------------------------------------------------------
def _same_nonfinite_close(got, want):
    """Non-finite at the same places (an Inf row meeting a zero term gives
    NaN where the f32 product gives Inf), the finite values within the
    tolerance of the finite ones."""
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.isfinite(), want.isfinite())
    assert torch.equal(got.isnan() & want.isnan(), want.isnan())
    fin = want.isfinite()
    if bool(fin.any()):
        _close(got[fin], want[fin])


@pytest.mark.parametrize("case", ["skewed", "empty_groups", "alternating",
                                  "past_n_rows", "clamped_ids",
                                  "nonfinite_lhs", "inf_weights"])
def test_k9_wgmma_kernel_matches_plain_and_tiled(cuda, case):
    """The tensor-core kernel against the plain version (f32 products) and
    the SIMT tiled kernel on the same operands: a skewed router over 32
    experts at granite's gate shape, empty groups, one m-tile an expert
    (no two neighbouring tiles share weights; an odd number of tiles),
    tiles past ``n_rows`` (zeros), expert ids out of range (clamped, as
    the reference's gathers clamp), NaN/Inf rows (non-finite where the
    plain version is) and Inf weights (the split maps them to (w, 0,
    0))."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    E, K, N = 32, 1024, 512
    if case == "empty_groups":
        E, K, N = 6, 256, 384
        sizes = torch.tensor([300, 0, 0, 129, 0, 1], device=cuda)
    elif case == "alternating":
        E, K, N = 8, 256, 256
        sizes = torch.full((E,), 100, device=cuda)
    else:
        skew = 1.0 / torch.arange(1, E + 1, device=cuda) ** 1.2
        sizes = torch.bincount(torch.multinomial(
            skew, 2048, replacement=True, generator=gen), minlength=E)
    tokens = torch.randn((int(sizes.sum()), K), generator=gen,
                         device=cuda).to(torch.bfloat16)
    w = torch.randn((E, K, N), generator=gen, device=cuda) * K ** -0.5
    if case == "nonfinite_lhs":
        tokens[3, 7] = float("nan")
        tokens[100, 0] = float("inf")
        tokens[500, 9] = -float("inf")
    if case == "inf_weights":
        w[0, 5, 3] = float("inf")
        w[1, 0, 100] = -float("inf")
        w[2, 17, 200] = float("nan")
    gp = TOPS.moe_group_pad(tokens, sizes, E, K)
    te = gp.tile_expert
    n_rows = gp.n_rows
    if case == "clamped_ids":
        te = te.clone()
        te[0], te[2] = -3, E + 5
    if case == "past_n_rows":
        n_rows = torch.tensor([256], dtype=torch.int32, device=cuda)
    before = TK9.moe_group_matmul_wgmma.launches
    got = TK9.moe_group_matmul_wgmma(gp.lhs, w, te, n_rows=n_rows)
    again = TK9.moe_group_matmul_wgmma(gp.lhs, w, te, n_rows=n_rows)
    torch.cuda.synchronize()
    assert TK9.moe_group_matmul_wgmma.launches == before + 2
    assert torch.equal(got.isnan(), again.isnan())
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(again))
    want = TK9.moe_group_matmul_padded_plain(gp.lhs, w, te, n_rows=n_rows)
    tiled = TK9.moe_group_matmul_padded(gp.lhs, w, te, n_rows=n_rows)
    _same_nonfinite_close(got, want)
    _same_nonfinite_close(got, tiled)
    if case in ("skewed", "past_n_rows"):
        assert bool(got.isfinite().all())
    dead = int(n_rows)
    assert float(got[dead:].abs().max()) == 0.0
    if case == "past_n_rows":
        assert float(got[:dead].abs().max()) > 0.0
    # given the tiles' row counts, rows past them are zero
    cut = TK9.moe_group_matmul_wgmma(gp.lhs, w, te, n_rows=n_rows,
                                     tile_rows=gp.tile_rows)
    live = (torch.arange(128, device=cuda)[None, :]
            < gp.tile_rows[:, None]).reshape(-1)
    assert float(cut[~live].abs().max()) == 0.0
    assert torch.equal(torch.nan_to_num(cut[live]),
                       torch.nan_to_num(got[live]))


def test_k9_wgmma_wrapper_validates_operands(cuda):
    lhs = torch.zeros((256, 128), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((2, 128, 128), device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):           # f32 rows keep the tiled kernel
        TK9.moe_group_matmul_wgmma(lhs.float(), w, te)
    with pytest.raises(ValueError):          # one expert id per m-tile
        TK9.moe_group_matmul_wgmma(lhs, w, te[:1])
    with pytest.raises(ValueError):          # on another device
        TK9.moe_group_matmul_wgmma(lhs, w.cpu(), te)
    before = TK9.moe_group_matmul_wgmma.launches
    out = TK9.moe_group_matmul_wgmma(lhs, w, te, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and float(out.abs().max()) == 0.0
    assert TK9.moe_group_matmul_wgmma.launches == before + 1



# ---------------------------------------------------------------------------
# K1 / K8 redesigned: work items with a row_len stop and split deep slices
# ---------------------------------------------------------------------------
def _k1_stream(cuda, case):
    """A SELL-C-σ stream: one row of 200,000 entries among short rows,
    empty slices and zero-width slices (empty rows), or a suite matrix."""
    if case == "dense_row":
        m, n = 3000, 200_000
        rng = np.random.default_rng(7)
        short = rng.integers(0, 6, m)
        short[100:400] = 0                       # whole slices of empty rows
        rows = np.concatenate([np.full(n, 5), np.repeat(np.arange(m),
                                                        short)])
        cols = np.concatenate([np.arange(n), rng.integers(0, n,
                                                          short.sum())])
        vals = rng.standard_normal(rows.size).astype(np.float32)
        coo = TM.as_coo((rows, cols, vals, (m, n)), device=cuda)
        return coo, coo_to_sellcs(coo, c=48)
    coo = _matrix(cuda, case)
    return coo, coo_to_sellcs(coo)


@pytest.mark.parametrize("k", [1, 4, 8, 32, 33, 64, 65, 128, 129])
@pytest.mark.parametrize("case", ["dense_row", "mawi_like", "hhh_like"])
def test_k1_matches_plain_with_and_without_row_len(cuda, case, k):
    """K1 against its plain version, with ``row_len`` (the padding is not
    walked) and without (it is, as in the reference), two launches bitwise
    equal, and the whole multiply against the oracle."""
    coo, sc = _k1_stream(cuda, case)
    X = torch.randn((coo.shape[1], k), device=cuda)
    kw = dict(num_slices=sc.num_slices, chunk=sc.chunk)
    for rl in (sc.row_len, None):
        got = TK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X,
                              row_len=rl, **kw)
        _close(got, TK.sellcs_slots_plain(sc.data, sc.cols, sc.slice_ptr,
                                          X, row_len=rl, **kw))
        assert torch.equal(got, TK.sellcs_slots(
            sc.data, sc.cols, sc.slice_ptr, X, row_len=rl, **kw))
    _close(sellcs_spmm(sc, X), spmm_ref(coo, X.double()).float())


def test_k1_row_len_stop_skips_nonfinite_padding(cuda):
    """With ``row_len`` a NaN/Inf in X row 0 reaches only the slots whose
    rows name column 0, as in the plain version with the same mask."""
    coo, sc = _k1_stream(cuda, "mawi_like")
    X = torch.randn((coo.shape[1], 8), device=cuda)
    X[0, :4] = float("nan")
    X[0, 4:] = float("inf")
    kw = dict(num_slices=sc.num_slices, chunk=sc.chunk, row_len=sc.row_len)
    got = TK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X, **kw)
    want = TK.sellcs_slots_plain(sc.data, sc.cols, sc.slice_ptr, X, **kw)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    _close(got[fin], want[fin])


def test_k1_plan_is_built_once_and_counts_launches(cuda):
    """The plan is kept on ``slice_ptr`` and reused; a wrapper call counts
    one launch, the combine kernel's included."""
    from repro_torch.spmm import slots_plan as SP
    coo, sc = _k1_stream(cuda, "dense_row")
    X = torch.randn((coo.shape[1], 2), device=cuda)
    kw = dict(num_slices=sc.num_slices, chunk=sc.chunk, row_len=sc.row_len)
    before = TK.sellcs_slots.launches
    TK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X, **kw)
    plan = SP.cached_slots_plan(sc.slice_ptr, **kw)
    assert plan.n_segs >= 1 and plan.deepest >= 200_000
    TK.sellcs_slots(sc.data, sc.cols, sc.slice_ptr, X, **kw)
    assert SP.cached_slots_plan(sc.slice_ptr, **kw) is plan
    assert TK.sellcs_slots.launches == before + 2
    # the stream is validated once per plan, but other data/cols again
    with pytest.raises(TypeError):
        TK.sellcs_slots(sc.data, sc.cols.long(), sc.slice_ptr, X, **kw)
    with pytest.raises(ValueError):
        TK.sellcs_slots(sc.data[:, :-1], sc.cols[:, :-1], sc.slice_ptr, X,
                        **kw)
    assert TK.sellcs_slots.launches == before + 2


@pytest.mark.parametrize("k", [1, 8, 32, 33])
@pytest.mark.parametrize("label", ["row", "merge"])
def test_k8_equals_k1_on_the_slab_on_mesh_shards(cuda, label, k):
    """On row and merge-chunk shards (a merge span may start mid-slice:
    a negative depth base), K1 and K8 with the shard's ``row_len`` and
    depth base match their plain versions, and K8 on the full X is
    bitwise K1 on the slab ``X[col_map]``."""
    from repro_torch.spmm import distributed as TD
    coo, sc = _k1_stream(cuda, "dense_row")
    if label == "row":
        part = TD.partition_sellcs_rows(sc, 3, compact_x=True)
        shards = part.shards
    else:
        part = TD.partition_sellcs_nnz(sc, 3, num_chunks=2, compact_x=True)
        shards = [sh for sp in part.chunk_plan[1] for sh in sp.shards]
    gen = torch.Generator(device=cuda).manual_seed(1000 + k)
    X = torch.randn((coo.shape[1], k), device=cuda, generator=gen)
    for sh in shards:
        if sh.width_rows == 0:
            continue
        kw = dict(num_slices=sh.num_slices, chunk=part.chunk,
                  row_len=sh.t_row_len, depth_ptr=sh.t_ptr)
        fused = TK.sellcs_slots(sh.data, sh.cols, sh.slice_ptr, X,
                                col_map=sh.col_map, **kw)
        _close(fused, TK.sellcs_slots_plain(sh.data, sh.cols, sh.slice_ptr,
                                            X, col_map=sh.col_map, **kw))
        slab = X.index_select(0, sh.col_map)
        assert torch.equal(fused, TK.sellcs_slots(sh.data, sh.cols,
                                                  sh.slice_ptr, slab, **kw))


def test_fleet_k8_path_before_and_after_a_redeal(cuda):
    """A fleet over four positions of the card: the fused compact-X
    gather launches K8 before and after a position is lost, a cache-hit
    tenant pays no build, and every answer matches the oracle."""
    from repro_torch.core import PlanSpec
    from repro_torch.spmm import Fleet
    coo = _matrix(cuda, "road_like", 0.05)
    fleet = Fleet(devices=["cuda:0"] * 4)
    spec = PlanSpec(num_devices=4, mesh_shape=(4, 1), compact_x=True,
                    gather="fused")
    op = fleet.register("t0", coo, spec, k_hint=8)
    hit = fleet.register("t1", _matrix(cuda, "road_like", 0.05), spec,
                         k_hint=8)
    assert hit.plan is op.plan
    assert (hit.stats.sellcs_builds, hit.stats.partition_builds) == (0, 0)
    X = torch.randn((coo.shape[1], 8), device=cuda)
    want = spmm_ref(coo, X)
    for lost in (False, True):
        if lost:
            assert sorted(fleet.handle_device_loss([3])) == ["t0", "t1"]
            assert op.spec.num_devices == 3 and hit.plan is op.plan
        before = TK.sellcs_slots.fused_launches
        _close(op @ X, want)
        _close(hit @ X, want)
        assert TK.sellcs_slots.fused_launches > before


@pytest.mark.parametrize("k", [1, 32])
def test_autotune_candidates_on_the_card(cuda, k):
    """``autotune`` on the card: the candidate grid and its best, and each
    candidate's answer, through the route it is timed on (``impl="auto"``:
    K4/K2 and the carry step, K1, a blocked oracle), against the
    oracle."""
    from repro_torch.core import autotune, convert, spmv
    algos = ("parcrs", "csb", "bcohch", "mergeb", "sellcs")
    coo = _matrix(cuda, "road_like", 0.05)
    best, res = autotune(coo, num_spmvs=100, reps=2, algorithms=algos,
                         betas=[256], k=k)
    assert [r.algorithm for r in res] == list(algos)
    assert best.total_s == min(r.total_s for r in res)
    X = torch.randn((coo.shape[1], k), device=cuda)
    want = spmm_ref(coo, X)
    for algo in algos:
        spec = ALGORITHM_SPECS[algo]
        kw = {"beta": 256} if spec.blocked else {}
        if spec.scheduling == "static_rows":
            kw["num_bands"] = 8
        mat = convert(coo, algo, **kw)
        if k == 1:
            _close(spmv(mat, X[:, 0]), want[:, 0])
        else:
            _close(spmm(mat, X), want)


def test_ssm_forward_matches_naive_on_the_card(cuda):
    """The chunked Mamba-2 scan on the card (float32, 3 chunks of 64, the
    last one ragged) against its step-by-step recurrence and against the
    same forward on the CPU."""
    from repro_torch.models import ssm as TS
    cfg = TS.SSMConfig(d_model=256, d_state=64, headdim=64, chunk=64)
    params = TS.ssm_init(torch.Generator(device=cuda).manual_seed(0), cfg)
    u = torch.randn((2, 150, 256), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    with torch.no_grad():
        got = TS.ssm_forward(params, cfg, u)
        _close(got, TS.ssm_forward_naive(params, cfg, u))
        cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.cpu())
               for k, v in params.items()}
        _close(got.cpu(), TS.ssm_forward(cpu, cfg, u.cpu()))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One AdamW step of jamba reduced (SSM, attention, MoE through the
    per-expert route) on the card and on the CPU from the same parameters
    and tokens: the loss, every gradient leaf and the step's metrics
    agree; float32 sums in another order."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models.model import init_params, loss_fn
    from repro_torch.optim import constant_lr, make_optimizer
    from repro_torch.optim.adamw import leaves
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        params = init_params(torch.Generator().manual_seed(0), cfg)
        params = params.to(dev)
        loss, _ = loss_fn(params, cfg, tokens.to(dev))
        grads = torch.autograd.grad(loss, leaves(params))
        opt = make_optimizer("adamw", constant_lr(1e-3))
        _, m = make_train_step(cfg, opt)(
            TrainState(params, opt.init(params)), {"tokens": tokens.to(dev)})
        out[str(dev)] = (loss.detach(), grads, m)
    (l0, g0, m0), (l1, g1, m1) = out["cpu"], out[str(cuda)]
    _close(l1.cpu(), l0)
    for a, b in zip(g1, g0):
        _close(a.cpu(), b)
    for k in ("loss", "ce", "aux", "grad_norm"):
        _close(m1[k].cpu(), m0[k])
