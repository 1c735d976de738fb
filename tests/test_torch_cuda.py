"""repro_torch CUDA kernels against their plain PyTorch versions, on the
card. Every test here carries the ``cuda`` marker and skips without a CUDA
device. The file imports no JAX, so it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ``max|kernel - plain| <= 1e-4 * max(1, max|plain|)`` (float32
sums in another order), as in ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import coo_to_csr
from repro_torch.data import matrices as TM
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import ops as TOPS
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import (coo_to_sellcs, csr_spmm, sellcs_spmm, spmm,
                              spmm_ref)

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
