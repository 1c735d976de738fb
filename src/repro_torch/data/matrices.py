"""Synthetic unstructured sparse matrix generators (numpy).

The paper's test set (Table 5.1) comes from the SuiteSparse collection plus
two random matrices (HHH, LHH). Each *class* is regenerated with matched
statistics (density regime, row-length variance, pathological skew):

  uniform        — HHH / LHH / cage15 (low row variance, uniform)
  rmat           — kron_g500, com-Orkut (power-law, heavy skew)
  powerlaw       — LiveJournal, ljournal-2008, uk-2002 (degree power law)
  mesh2d         — road_usa, hugetrace, hugebubbles (bounded degree, local)
  mawi_like      — mawi_201512020130 (ONE near-dense row; breaks
                   row-distributed balancing, paper Table 6.3)

Generators are deterministic in ``seed`` and return host numpy triplets —
the same triplets, bit for bit, as ``repro.data.matrices`` for the same
arguments; ``as_coo`` moves them to a device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.core.convert import to_coo
from repro_torch.core.device import DeviceLike
from repro_torch.core.formats import COO


def _dedupe(rows, cols, m, n):
    key = rows.astype(np.int64) * n + cols.astype(np.int64)
    key = np.unique(key)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def uniform(m: int, n: int, nnz: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz, dtype=np.int64)
    cols = rng.integers(0, n, nnz, dtype=np.int64)
    rows, cols = _dedupe(rows, cols, m, n)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """Recursive MATrix (Graph500 kron generator): power-law degrees."""
    rng = np.random.default_rng(seed)
    m = n = 1 << scale
    nnz = edge_factor * m
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for bit in range(scale):
        r = rng.random(nnz)
        quad_ab = r < a + b           # top half
        quad_ac_given = rng.random(nnz)
        go_right_top = (r >= a) & quad_ab
        go_right_bot = quad_ac_given >= (c / max(1 - a - b, 1e-9))
        right = np.where(quad_ab, go_right_top, go_right_bot)
        down = ~quad_ab
        rows |= down.astype(np.int64) << bit
        cols |= right.astype(np.int64) << bit
    rows, cols = _dedupe(rows, cols, m, n)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


def powerlaw(m: int, n: int, nnz: int, alpha: float = 1.8, seed: int = 0):
    """Degree-sequence model: row degrees ~ Zipf(alpha), columns uniform."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, m + 1, dtype=np.float64) ** (-alpha))
    rng.shuffle(w)
    w /= w.sum()
    rows = rng.choice(m, size=nnz, p=w).astype(np.int64)
    cols = rng.integers(0, n, nnz, dtype=np.int64)
    rows, cols = _dedupe(rows, cols, m, n)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


def mesh2d(side: int, seed: int = 0):
    """5-point stencil on a side x side grid: the paper's road/hugetrace
    class (max 3-5 nnz/row, tiny variance)."""
    rng = np.random.default_rng(seed)
    m = n = side * side
    idx = np.arange(m, dtype=np.int64)
    r, c = idx // side, idx % side
    nbrs = []
    for dr, dc in ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0)):
        rr, cc = r + dr, c + dc
        ok = (rr >= 0) & (rr < side) & (cc >= 0) & (cc < side)
        nbrs.append((idx[ok], (rr * side + cc)[ok]))
    rows = np.concatenate([a for a, _ in nbrs])
    cols = np.concatenate([b for _, b in nbrs])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, (m, n)


def mawi_like(m: int, n: int, nnz: int, dense_row_frac: float = 0.3,
              seed: int = 0):
    """Background uniform sparsity + ONE row holding ``dense_row_frac`` of
    all nonzeros (paper: mawi has a row with 1.2e8 of 2.7e8 nnz)."""
    rng = np.random.default_rng(seed)
    hot = int(nnz * dense_row_frac)
    hot_row = int(rng.integers(0, m))
    r1 = np.full(hot, hot_row, np.int64)
    c1 = rng.choice(n, size=min(hot, n), replace=False).astype(np.int64)
    r1 = r1[: c1.size]
    r2 = rng.integers(0, m, nnz - c1.size, dtype=np.int64)
    c2 = rng.integers(0, n, nnz - c1.size, dtype=np.int64)
    rows = np.concatenate([r1, r2])
    cols = np.concatenate([c1, c2])
    rows, cols = _dedupe(rows, cols, m, n)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


def as_coo(gen_result, dtype=np.float32, device: DeviceLike = None) -> COO:
    """Generator triplets -> canonical COO on ``device`` (default cuda)."""
    rows, cols, vals, shape = gen_result
    return to_coo(rows, cols, vals.astype(dtype), shape, device=device)


@dataclasses.dataclass(frozen=True)
class TestMatrix:
    name: str
    density_class: str          # "low" | "high" | "skewed"
    make: Callable[[], tuple]


def _suite(scale: float = 1.0) -> Dict[str, TestMatrix]:
    """Scaled-down analogues of Table 5.1 (names reference the originals)."""
    s = scale

    def S(x):
        return max(int(x * s), 64)

    return {
        # --- low density class (density < 1e-6 in the paper) ---
        "europe_osm_like": TestMatrix(
            "europe_osm_like", "low",
            lambda: mesh2d(int(np.sqrt(S(262144))))),
        "road_like": TestMatrix(
            "road_like", "low", lambda: mesh2d(int(np.sqrt(S(131072))), 1)),
        "lhh_like": TestMatrix(
            "lhh_like", "low",
            lambda: uniform(S(262144), S(262144), S(524288), 2)),
        # --- higher density class ---
        "kron_like": TestMatrix(
            "kron_like", "high",
            lambda: rmat(max(int(np.log2(S(16384))), 8), 24, 3)),
        "livejournal_like": TestMatrix(
            "livejournal_like", "high",
            lambda: powerlaw(S(32768), S(32768), S(393216), 1.8, 4)),
        "hhh_like": TestMatrix(
            "hhh_like", "high",
            lambda: uniform(S(16384), S(16384), S(196608), 5)),
        "orkut_like": TestMatrix(
            "orkut_like", "high",
            lambda: rmat(max(int(np.log2(S(8192))), 8), 48, 6)),
        # --- pathological ---
        "mawi_like": TestMatrix(
            "mawi_like", "skewed",
            lambda: mawi_like(S(65536), S(65536), S(262144), 0.3, 7)),
    }


def test_suite(scale: float = 1.0) -> Dict[str, TestMatrix]:
    return _suite(scale)


# pytest collects names starting with "test"; this module is library code
test_suite.__test__ = False
TestMatrix.__test__ = False
