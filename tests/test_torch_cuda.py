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

from repro_torch.core import coo_to_csr
from repro_torch.data import matrices as TM
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


@pytest.mark.parametrize("case", ["decode", "empty_groups", "f32_reduced"])
def test_grouped_gemm_kernel_matches_plain(cuda, case):
    tokens, w, sizes = _k9_operands(cuda, case)
    before = TK9.moe_group_matmul_padded.launches
    got = TOPS.moe_group_matmul(tokens, w, sizes)
    assert TK9.moe_group_matmul_padded.launches == before + 1
    want = TOPS.moe_group_matmul(tokens, w, sizes, plain=True)
    assert TK9.moe_group_matmul_padded.launches == before + 1
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
        TK9.moe_group_matmul_padded(lhs, w, te, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):          # one expert id per m-tile
        TK9.moe_group_matmul_padded(lhs, w, te[:1])
    with pytest.raises(ValueError):          # not contiguous
        TK9.moe_group_matmul_padded(
            torch.zeros((128, 256), device=cuda).t(), w, te)
    with pytest.raises(ValueError):          # on another device
        TK9.moe_group_matmul_padded(lhs, w.cpu(), te)


def test_moe_layer_kernel_route_matches_plain(cuda):
    """One granite MoE layer (d 1024, d_ff 512, 32 experts, top-8) on f32
    activations: K9 against its plain version through moe_apply, and the
    per-expert route."""
    from repro_torch.models import moe as TMOE
    cfg = TMOE.MoEConfig(1024, 512, 32, 8, use_kernel=True)
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = TMOE.moe_init(gen, cfg)
    x = torch.randn((2, 64, 1024), generator=gen, device=cuda)
    before = TK9.moe_group_matmul_padded.launches
    out, aux = TMOE.moe_apply(p, cfg, x)
    assert TK9.moe_group_matmul_padded.launches == before + 3
    plain, aux_p = TMOE.moe_apply(p, cfg._replace(plain=True), x)
    ragged, _ = TMOE.moe_apply(p, cfg._replace(use_kernel=False), x)
    assert TK9.moe_group_matmul_padded.launches == before + 3
    _close(out, plain)
    _close(out, ragged)
    assert float(aux) == float(aux_p)
