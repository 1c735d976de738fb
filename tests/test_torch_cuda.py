"""repro_torch CUDA kernels (K1–K7 and the carry step) against their plain
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
