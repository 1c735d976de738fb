"""Pure-torch oracles of the tiled kernels and the grouped GEMM
(``repro.kernels.ref``).

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


def moe_group_matmul_ref(tokens: torch.Tensor, weights: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """Oracle for the grouped GEMM: tokens [T, K] sorted by expert,
    group_sizes int [E]; weights [E, K, N] -> f32 [T, N]. Gathers one
    weight block per token: for small shapes only."""
    T = tokens.shape[0]
    bounds = torch.cumsum(group_sizes.to(torch.int64), 0)
    expert_of_token = torch.searchsorted(
        bounds, torch.arange(T, device=tokens.device), right=True)
    w = weights[expert_of_token.clamp(max=weights.shape[0] - 1)]
    return torch.einsum("tk,tkn->tn", tokens.to(torch.float32),
                        w.to(torch.float32))
