"""The plain reference of the benchmark: ``y = A x`` recomputed from the
triplets that the benchmark made, and the number that decides ``correct``.

It imports torch alone: nothing of the program, nothing of JAX. It takes
nothing that the program made: the triplets are the benchmark's own, the
``x`` are the requests the benchmark drew, and the program's answers are
only read to be judged.

The number compared is the normalised error of an answer,
``max_r |y[r] - ref[r]| / sum_j |a_rj x_j|``: the error of each row
against the size of the terms its sum adds, the quantity that rounding
bounds (about ``row length * 2**-24`` in float32, about ``2**-8`` in
bfloat16). A row with no nonzeros has to come out as exactly 0.
"""
from __future__ import annotations

from typing import Tuple

import torch

# the floor under a row's term size: an empty row's answer must be 0, and
# any other value reads as a huge error
_TINY = 1e-300


class Reference:
    """``A`` from the benchmark's host triplets, on ``device``, in float64
    (the reference) or in a lower precision (the control)."""

    def __init__(self, triplets, device, dtype=torch.float64):
        rows, cols, vals, shape = triplets
        self.shape = tuple(shape)
        self.device = torch.device(device)
        self.dtype = dtype
        self.rows = torch.as_tensor(rows).to(self.device, torch.int64)
        self.cols = torch.as_tensor(cols).to(self.device, torch.int64)
        self.vals = torch.as_tensor(vals).to(self.device, dtype)

    def matvec(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(A x, |A| |x|)`` in this reference's dtype, for one request."""
        m = self.shape[0]
        prod = self.vals * x.to(self.device, self.dtype)[self.cols]
        y = torch.zeros(m, dtype=self.dtype, device=self.device)
        y.index_add_(0, self.rows, prod)
        size = torch.zeros(m, dtype=self.dtype, device=self.device)
        size.index_add_(0, self.rows, prod.abs())
        return y, size

    def matmul(self, X: torch.Tensor) -> torch.Tensor:
        """``A X`` for ``X [n, k]``, one column at a time (the control put in
        the program's place)."""
        cols = [self.matvec(X[:, j])[0] for j in range(X.shape[1])]
        return torch.stack(cols, dim=1)


def normalised_error(ref: Reference, x: torch.Tensor,
                     y: torch.Tensor) -> float:
    """``max_r |y[r] - (A x)[r]| / sum_j |a_rj x_j|`` against the float64
    reference; ``inf`` for an answer of the wrong shape, NaN or Inf."""
    if tuple(y.shape) != (ref.shape[0],):
        return float("inf")
    exact, size = ref.matvec(x)
    diff = (y.to(ref.device, torch.float64) - exact).abs()
    err = diff / size.clamp_min(_TINY)
    worst = float(err.max()) if err.numel() else 0.0
    return worst if worst == worst else float("inf")   # NaN -> inf
