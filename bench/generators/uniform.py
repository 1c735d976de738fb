"""The matrix class ``uniform``: the uniform class of the paper's Table 5.1
(HHH, LHH; SuiteSparse cage15). Exactly ``nnz`` distinct (row, col)
positions drawn uniformly over the matrix, standard normal values: rows of
Poisson length around ``nnz / m``, columns spread over the whole matrix.

A generator module exports ``generate(g, device, **params)``, drawing on
``device`` from the ``torch.Generator`` ``g`` in a few large calls, and
returns host triplets ``(rows int32, cols int32, vals float32, (m, n))``.
The same seed gives the same triplets, and every seed the same ``nnz``."""
import torch

from benchlib.matrices import to_host


def generate(g: torch.Generator, device, *, m: int, n: int, nnz: int):
    if not 0 < nnz <= m * n:
        raise ValueError(f"nnz {nnz} does not fit a {m} x {n} matrix")
    # a few more draws than needed cover the duplicates (about
    # nnz**2 / (2 m n) of them); then exactly nnz of the distinct ones
    draws = min(m * n, nnz + nnz // 1000 + 64)
    while True:
        rows = torch.randint(0, m, (draws,), generator=g, device=device)
        cols = torch.randint(0, n, (draws,), generator=g, device=device)
        key = torch.unique(rows * n + cols)
        del rows, cols
        if key.numel() >= nnz:
            break
        draws = min(m * n, 2 * draws)
    pick = torch.randperm(key.numel(), generator=g, device=device)[:nnz]
    key = torch.sort(key[pick]).values           # row-major order
    vals = torch.randn(nnz, generator=g, device=device)
    return to_host(key // n, key % n, vals, (m, n))
