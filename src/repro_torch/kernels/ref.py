"""Pure-torch oracles of the tiled kernels (``repro.kernels.ref``).

Each is a gather of the x slabs, an einsum and an ``index_add_``; they
multiply in float32 without rounding x to the tile dtype (as the
reference's oracles do), so with bf16 tiles the kernels and their plain
versions are held to the Pallas kernel's rounding, not to these.
"""
from __future__ import annotations

import torch

from .tiling import TILE_C, TILE_R, TiledSparse


def bsr_spmm_ref(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """Oracle for the multi-RHS tiled multiply: X [n, R] -> f32 [m, R]."""
    m, n = ts.shape
    mp, np_ = ts.padded_shape()
    R = x.shape[1]
    x_pad = torch.zeros((np_, R), dtype=torch.float32, device=x.device)
    x_pad[:n] = x
    xs = x_pad.view(np_ // TILE_C, TILE_C, R)[ts.tile_cols.long()]
    contrib = torch.einsum("trc,tcf->trf", ts.tiles.to(torch.float32), xs)
    y = torch.zeros((mp // TILE_R, TILE_R, R), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, ts.tile_rows.long(), contrib)
    return y.view(mp, R)[:m]


def bsr_spmv_ref(ts: TiledSparse, x: torch.Tensor) -> torch.Tensor:
    """Oracle for the tiled SpMV: x [n] -> f32 [m]."""
    m, n = ts.shape
    mp, np_ = ts.padded_shape()
    x_pad = torch.zeros(np_, dtype=torch.float32, device=x.device)
    x_pad[:n] = x
    xs = x_pad.view(np_ // TILE_C, TILE_C)[ts.tile_cols.long()]
    contrib = torch.einsum("trc,tc->tr", ts.tiles.to(torch.float32), xs)
    y = torch.zeros((mp // TILE_R, TILE_R), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, ts.tile_rows.long(), contrib)
    return y.view(mp)[:m]
