"""The matrix class ``road_grid``: the low-density road class of the
paper's Table 5.1 (SuiteSparse DIMACS10 road_usa): a symmetric pattern
with no diagonal, about 2.4 nonzeros a row, 1 to 4 in each, with local
columns.

The ``n`` vertices lie row by row on a grid ``width`` wide (the last grid
row may be short). Every horizontal edge ``(i, i + 1)`` inside a grid row
is kept, so that no row of the matrix is empty (a road's junctions and
bends); of the vertical edges ``(i, i + width)``, exactly as many as make
``nnz`` are kept, chosen uniformly from the seed. Each kept edge gives the
two nonzeros ``(i, j)`` and ``(j, i)``; values are standard normal, one
for each nonzero. Every seed gives the same ``nnz``.

Exports ``generate(g, device, **params)`` (see ``uniform.py``)."""
import torch

from benchlib.matrices import to_host


def edge_counts(n: int, width: int):
    """(horizontal edges, vertical candidates) of ``n`` vertices on a grid
    ``width`` wide."""
    grid_rows = -(-n // width)
    return n - grid_rows, max(n - width, 0)


def generate(g: torch.Generator, device, *, n: int, width: int, nnz: int):
    horizontal, candidates = edge_counts(n, width)
    vertical = nnz // 2 - horizontal
    if nnz % 2 or not 0 <= vertical <= candidates:
        raise ValueError(f"nnz {nnz} is not 2 x (the {horizontal} "
                         f"horizontal edges + 0..{candidates} vertical)")
    idx = torch.arange(n - 1, dtype=torch.int64, device=device)
    left = idx[(idx + 1) % width != 0]                 # (i, i + 1)
    up = torch.randperm(candidates, generator=g, device=device)[:vertical]
    src = torch.cat([left, up])
    dst = torch.cat([left + 1, up + width])
    rows = torch.cat([src, dst])
    cols = torch.cat([dst, src])
    vals = torch.randn(rows.numel(), generator=g, device=device)
    return to_host(rows, cols, vals, (n, n))
