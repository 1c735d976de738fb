"""Space-filling curves used to order nonzeros / blocks for locality.

The paper (§3.1, §3.2, §4) uses two curves:
  * Z-Morton  — bit interleave of (row, col); used by CSB.
  * Hilbert   — orientation-preserving curve; used by BCOH and the *H hybrids.

The tensor versions compute in int64 and mask every intermediate to 32 bits,
which reproduces the uint32 wrap-around arithmetic of ``repro.core.curves``
exactly (most torch ops do not take ``torch.uint32``): every key equals the
reference's, returned as int64. They run on any device. ``hilbert_key_np``
is the numpy twin used by the host-side conversions.
"""
from __future__ import annotations

import numpy as np
import torch

# 16 bits per coordinate == the paper's compressed-index width (16+16 packed
# into a 32-bit integer, §3.1). Curve keys therefore fit in 32 bits.
MAX_ORDER = 16

_U32 = 0xFFFFFFFF


def _u32(v) -> torch.Tensor:
    """``v`` as int64 holding its uint32 value (wrapped as a uint32 cast
    would wrap it)."""
    return torch.as_tensor(v).to(torch.int64) & _U32


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``v`` so there is a zero between each bit."""
    v = _u32(v)
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _compact1by1(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_part1by1`."""
    v = _u32(v) & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def morton_key(row, col) -> torch.Tensor:
    """Z-Morton key. Row bits are the *high* bits of each interleaved pair so
    the curve sweeps quadrants top-left, top-right, bottom-left, bottom-right
    (Fig. 3.1 of the paper)."""
    return ((_part1by1(row) << 1) | _part1by1(col)) & _U32


def morton_decode(key):
    """Inverse of :func:`morton_key` -> (row, col), int32."""
    key = _u32(key)
    row = _compact1by1(key >> 1)
    col = _compact1by1(key)
    return row.to(torch.int32), col.to(torch.int32)


def hilbert_key(row, col, order: int = MAX_ORDER) -> torch.Tensor:
    """Hilbert curve index of (row, col) on a 2**order x 2**order grid.

    The classic xy->d algorithm [Hilbert 1891; the paper's Fig. 3.2]:
    ``order`` branch-free rotate-and-accumulate steps."""
    if order > 16:
        raise ValueError("order > 16 would overflow the 32-bit key")
    x = _u32(col)
    y = _u32(row)
    d = torch.zeros_like(x)
    n = 1 << order
    s = 1 << (order - 1)
    for _ in range(order):
        rx = ((x & s) > 0).to(torch.int64)
        ry = ((y & s) > 0).to(torch.int64)
        d = (d + s * s * ((3 * rx) ^ ry)) & _U32
        # rotate the quadrant: when ry == 0, optionally flip (within the
        # full n-grid, wrapped as uint32), then swap x/y
        flip = (ry == 0) & (rx == 1)
        x_new = torch.where(ry == 0,
                            torch.where(flip, (n - 1 - y) & _U32, y), x)
        y_new = torch.where(ry == 0,
                            torch.where(flip, (n - 1 - x) & _U32, x), y)
        x, y = x_new, y_new
        s >>= 1
    return d


def hilbert_decode(key, order: int = MAX_ORDER):
    """Inverse of :func:`hilbert_key` -> (row, col), int32."""
    t = _u32(key)
    x = torch.zeros_like(t)
    y = torch.zeros_like(t)
    s = 1
    for _ in range(order):
        rx = (t >> 1) & 1
        ry = (t ^ rx) & 1
        # rotate (x, y < s here, so flipping within the s-square is exact)
        flip = (ry == 0) & (rx == 1)
        x_f = torch.where(flip, (s - 1 - x) & _U32, x)
        y_f = torch.where(flip, (s - 1 - y) & _U32, y)
        x, y = torch.where(ry == 0, y_f, x_f), torch.where(ry == 0, x_f, y_f)
        x = (x + s * rx) & _U32
        y = (y + s * ry) & _U32
        t = t >> 2
        s <<= 1
    return y.to(torch.int32), x.to(torch.int32)   # (row, col)


def curve_key(row, col, order: str = "hilbert",
              bits: int = MAX_ORDER) -> torch.Tensor:
    """Uniform entry point: ``order`` in {"row", "morton", "hilbert"}.

    "row" returns the row-major key (row * 2**bits + col), matching the
    paper's row-wise nonzero ordering used by CRS/BCOHC/MergeB."""
    if order == "row":
        return ((_u32(row) << bits) | _u32(col)) & _U32
    if order == "morton":
        return morton_key(row, col)
    if order == "hilbert":
        return hilbert_key(row, col, bits)
    raise ValueError(f"unknown curve order {order!r}")


def hilbert_key_np(row, col, order: int = MAX_ORDER) -> np.ndarray:
    """numpy twin of :func:`hilbert_key` (int64 keys; the host-side
    conversion path)."""
    x = np.asarray(col, dtype=np.int64).copy()
    y = np.asarray(row, dtype=np.int64).copy()
    d = np.zeros_like(x)
    n = np.int64(1 << order)
    s = np.int64(1 << (order - 1))
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        x_new = np.where(ry == 0, np.where(rx == 1, n - 1 - y, y), x)
        y_new = np.where(ry == 0, np.where(rx == 1, n - 1 - x, x), y)
        x, y = x_new, y_new
        s >>= 1
    return d
