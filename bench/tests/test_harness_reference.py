"""The plain reference against a dense product at a tiny size, and the
normalised error that decides ``correct``."""
import numpy as np
import pytest
import torch

from benchlib import matrices
from benchlib.reference import Reference, normalised_error
from conftest import TINY

CPU = torch.device("cpu")


def _dense(triplets):
    rows, cols, vals, (m, n) = triplets
    A = np.zeros((m, n))
    np.add.at(A, (rows, cols), vals.astype(np.float64))
    return A


@pytest.mark.parametrize("gen", sorted(TINY))
def test_reference_equals_the_dense_product(gen):
    trip = matrices.generate({"generator": gen, "params": TINY[gen]},
                             3_000_000_001, CPU)
    ref = Reference(trip, CPU)
    x = torch.randn(trip[3][1], generator=torch.Generator().manual_seed(1))
    y, size = ref.matvec(x)
    A = _dense(trip)
    np.testing.assert_allclose(y.numpy(), A @ x.double().numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(size.numpy(),
                               np.abs(A) @ np.abs(x.double().numpy()),
                               rtol=1e-12, atol=1e-12)
    X = torch.stack([x, -2 * x], dim=1)
    np.testing.assert_allclose(ref.matmul(X).numpy()[:, 1],
                               -2 * (A @ x.double().numpy()), rtol=1e-12,
                               atol=1e-12)


def test_normalised_error_reads_rounding_and_faults():
    trip = matrices.generate({"generator": "uniform",
                              "params": TINY["uniform"]}, 5, CPU)
    ref = Reference(trip, CPU)
    x = torch.randn(trip[3][1], generator=torch.Generator().manual_seed(2))
    exact, size = ref.matvec(x)
    assert normalised_error(ref, x, exact.float()) < 1e-7
    bad = exact.float().clone()
    r = int(torch.argmax(size))
    bad[r] += 1e-3 * float(size[r])
    assert normalised_error(ref, x, bad) == pytest.approx(1e-3, rel=1e-3)
    nan = exact.float().clone()
    nan[0] = float("nan")
    assert normalised_error(ref, x, nan) == float("inf")
    assert normalised_error(ref, x, exact.float()[:-1]) == float("inf")


def test_an_empty_row_must_answer_zero():
    trip = (np.array([0], np.int32), np.array([1], np.int32),
            np.array([2.0], np.float32), (3, 3))
    ref = Reference(trip, CPU)
    x = torch.ones(3)
    assert normalised_error(ref, x, torch.tensor([2.0, 0.0, 0.0])) == 0
    assert normalised_error(ref, x, torch.tensor([2.0, 1e-30, 0.0])) > 1e200


@pytest.mark.parametrize("gen", sorted(TINY))
def test_generators_repeat_per_seed_and_differ_across(gen):
    cfg = {"generator": gen, "params": TINY[gen]}
    a = matrices.generate(cfg, 2 ** 31 + 7, CPU)
    b = matrices.generate(cfg, 2 ** 31 + 7, CPU)
    c = matrices.generate(cfg, 2 ** 31 + 8, CPU)
    for u, v in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(u, v)
    assert not np.array_equal(a[2], c[2])
    rows, cols = a[0], a[1]
    key = rows.astype(np.int64) * a[3][1] + cols
    assert np.unique(key).size == key.size        # no duplicates
    # every seed the same number of nonzeros
    assert rows.size == c[0].size == TINY[gen]["nnz"]
    if gen == "road_grid":
        # symmetric, no diagonal, 1 to 4 a row, columns at +-1, +-width
        n, width = TINY[gen]["n"], TINY[gen]["width"]
        pairs = set(zip(rows.tolist(), cols.tolist()))
        assert all((j, i) in pairs for i, j in pairs)
        deg = np.bincount(rows, minlength=n)
        assert deg.min() >= 1 and deg.max() <= 4
        assert set(np.abs(rows.astype(np.int64) - cols)) == {1, width}


def test_seeds_of_matrix_and_requests_never_coincide():
    for s in (0, 1, 2 ** 31, 2 ** 63 + 5):
        assert matrices.matrix_seed(s) % 2 == 0
        assert matrices.request_seed(s) % 2 == 1
