"""Storage format conversion (paper §5.1), host side.

Conversion = (1) sort nonzeros into the target ordering, (2) populate the
target arrays. It runs in numpy on the host, as in the JAX package, and the
result moves to the target device once. Each converted object keeps the
host arrays it was built from, so later host planning (the merge plan)
never copies them back from the card.

This slice carries the flat CRS algorithms (``parcrs``, ``merge``) and
``sellcs``; the blocked paper formats come with the blocked-format slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .formats import COO, CSR


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    blocked: bool
    note: str = ""


ALGORITHM_SPECS = {
    "parcrs": AlgorithmSpec("parcrs", False, "dynamic row loop"),
    "merge": AlgorithmSpec("merge", False,
                           "merge-path on flat CSR [Merrill&Garland]"),
    "csb": AlgorithmSpec("csb", True, "Buluc et al. 2009"),
    "csbh": AlgorithmSpec("csbh", True, "hybrid #1"),
    "bcoh": AlgorithmSpec("bcoh", True, "Yzelman&Roose 2014"),
    "bcohc": AlgorithmSpec("bcohc", True, "hybrid #2"),
    "bcohch": AlgorithmSpec("bcohch", True, "hybrid #3"),
    "bcohchp": AlgorithmSpec("bcohchp", True, "hybrid #4"),
    "mergeb": AlgorithmSpec("mergeb", True, "hybrid #5"),
    "mergebh": AlgorithmSpec("mergebh", True, "hybrid #6"),
    "sellcs": AlgorithmSpec("sellcs", False,
                            "SELL-C-σ slices (Kreutzer et al.) — "
                            "converted by repro_torch.spmm.sellcs"),
}

BLOCKED_SLICE = ("the blocked paper formats (CSB/BCOH families and their "
                 "hybrids) are not ported yet: they come with the "
                 "blocked-format slice (ROADMAP queue 1, module 8)")


def coo_canonicalize_np(rows, cols, vals, shape):
    """Sort row-major and sum duplicates (host)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        key = rows * shape[1] + cols
        uniq, inv = np.unique(key, return_inverse=True)
        if uniq.size != rows.size:
            out = np.zeros(uniq.size, vals.dtype)
            np.add.at(out, inv, vals)
            rows, cols, vals = uniq // shape[1], uniq % shape[1], out
    return rows.astype(np.int32), cols.astype(np.int32), vals


_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64,
                torch.float16: np.float16}


def to_coo(rows, cols, vals, shape, dtype=torch.float32,
           device: DeviceLike = None) -> COO:
    """Canonical COO on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    r, c, v = coo_canonicalize_np(rows, cols, vals, shape)
    v = v.astype(_NP_OF_TORCH.get(dtype, np.float32))
    return COO(torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev),
               torch.from_numpy(v).to(dev, dtype), tuple(shape),
               host=(r, c, v))


def coo_to_csr(coo: COO) -> CSR:
    m, n = coo.shape
    rows, cols, vals = coo.host_triplets()
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_ptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=row_ptr[1:])
    cols = cols.astype(np.int32)
    dev = coo.device
    return CSR(torch.from_numpy(row_ptr).to(dev),
               torch.from_numpy(cols).to(dev),
               torch.from_numpy(np.ascontiguousarray(vals)).to(dev),
               coo.shape, host=(row_ptr, cols, vals))


def convert(coo: COO, algorithm: str, **kw):
    """Uniform entry point: COO -> the storage format ``algorithm`` needs.

    ``sellcs`` goes through ``repro_torch.spmm.sellcs`` (kw: ``c``,
    ``sigma``); the flat CRS-based algorithms ignore kw; the blocked
    algorithms raise ``NotImplementedError`` until their slice lands."""
    spec = ALGORITHM_SPECS[algorithm]
    if algorithm == "sellcs":
        from repro_torch.spmm.sellcs import coo_to_sellcs   # late: core <- spmm
        return coo_to_sellcs(coo, **kw)
    if spec.blocked:
        raise NotImplementedError(f"{algorithm!r}: {BLOCKED_SLICE}")
    return coo_to_csr(coo)
