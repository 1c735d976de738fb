"""Public wrappers around the single-vector, tiled and grouped-GEMM
kernels.

``plain=True`` runs the kernels' plain PyTorch versions on any device (the
counterpart of the reference's ``interpret=True``); otherwise a CUDA tensor
launches the CUDA kernels and a CPU tensor takes the plain versions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.formats import CSR
from . import bsr_spmv as _bsr
from . import merge_spmv as _merge
from . import moe_group_matmul as _moe
from .tiling import TiledSparse

M_TILE = _moe.M_TILE
# ``moe_group_matmul`` takes K9's decode kernel when the rows average at
# most this many per expert (from the shapes alone, no host sync); see
# PERF.md for the measured crossover against the tiled kernel
DECODE_ROWS_PER_EXPERT = 48


def bsr_spmv(ts: TiledSparse, x: torch.Tensor, *,
             plain: bool = False) -> torch.Tensor:
    """Tiled SpMV ``y = A x`` (K5) -> f32[m]."""
    if plain:
        return _bsr.bsr_spmv_plain(ts, x)
    return _bsr.bsr_spmv(ts, x)


def bsr_spmm(ts: TiledSparse, x: torch.Tensor, *,
             plain: bool = False) -> torch.Tensor:
    """Tiled multi-RHS ``Y = A X`` (K7), X [n, R] -> f32[m, R]."""
    if plain:
        return _bsr.bsr_spmm_plain(ts, x)
    return _bsr.bsr_spmm(ts, x)


def merge_spmv(csr: CSR, x: torch.Tensor, *, num_spans: Optional[int] = None,
               plan: Optional[_merge.MergePlan] = None,
               plain: bool = False) -> torch.Tensor:
    """Merge-path SpMV ``y = A x`` -> f32[m]. The plan is built once per
    CSR and span count (:func:`merge_spmv.cached_merge_plan`) and reused."""
    m, n = csr.shape
    if x.shape != (n,):
        raise ValueError(f"x must be [{n}], got {tuple(x.shape)}")
    if plan is None:
        plan = _merge.cached_merge_plan(csr, num_spans)
    x = x.to(torch.float32).contiguous()
    if plain:
        y, cr, cv = _merge.merge_partials_plain(plan, x[:, None], m)
        return _merge.carry_out_fixup_plain(y, cr, cv)[:, 0]
    y, cr, cv = _merge.merge_spmv_partials(plan, x, m)
    return _merge.carry_out_fixup(y, cr, cv)


class GroupPadding(NamedTuple):
    """Tokens sorted by expert, laid out with every group padded to
    ``M_TILE`` rows (``kernels.ops.moe_group_pad``)."""
    lhs: torch.Tensor          # [T_pad, Kp], zero outside the groups
    tile_expert: torch.Tensor  # int32 [T_pad / M_TILE], clipped to E - 1
    pos: torch.Tensor          # int64 [T], row of token t in lhs
    n_rows: torch.Tensor       # int32 [1], padded_ptr[E]: the real length
    tile_rows: torch.Tensor    # int32 [T_pad / M_TILE], real rows a tile


def moe_group_pad(tokens: torch.Tensor, group_sizes: torch.Tensor,
                  num_experts: int, k_pad: int) -> GroupPadding:
    """The reference's group padding (``repro.kernels.ops.moe_group_matmul``):
    a static worst-case length ``T_pad = ceil(T / 128) * 128 + E * 128``,
    each group starting at a multiple of 128, K zero-padded to ``k_pad``.
    Everything stays on the tokens' device (no host sync)."""
    T, K = tokens.shape
    E = num_experts
    if group_sizes.shape != (E,) or k_pad < K:
        raise ValueError(f"group_sizes must be [{E}] and k_pad >= {K}; got "
                         f"{tuple(group_sizes.shape)}, {k_pad}")
    dev = tokens.device
    T_pad = -(-T // M_TILE) * M_TILE + E * M_TILE
    sizes = group_sizes.to(device=dev, dtype=torch.int64)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ptr = torch.cat([zero, torch.cumsum(sizes, 0)])
    padded_sizes = -(-sizes // M_TILE) * M_TILE
    padded_ptr = torch.cat([zero, torch.cumsum(padded_sizes, 0)])
    tok_idx = torch.arange(T, dtype=torch.int64, device=dev)
    expert_of_token = torch.searchsorted(ptr[1:], tok_idx, right=True)
    pos = padded_ptr[expert_of_token] + (tok_idx - ptr[expert_of_token])
    lhs = torch.zeros((T_pad, k_pad), dtype=tokens.dtype, device=dev)
    lhs[pos, :K] = tokens
    tile_idx = torch.arange(T_pad // M_TILE, dtype=torch.int64, device=dev)
    tile_expert = torch.searchsorted(padded_ptr[1:], tile_idx * M_TILE,
                                     right=True).clamp(max=E - 1)
    # the real rows of each tile: the tokens whose row falls in it (four
    # small launches; a decode step makes three paddings a layer)
    tile_rows = torch.zeros(T_pad // M_TILE, dtype=torch.int32,
                            device=dev).index_add_(
        0, pos // M_TILE, torch.ones(T, dtype=torch.int32, device=dev))
    return GroupPadding(lhs, tile_expert.to(torch.int32), pos,
                        padded_ptr[E:].to(torch.int32), tile_rows)


def takes_decode_kernel(rows: int, num_experts: int) -> bool:
    """Whether ``moe_group_matmul`` routes ``rows`` expert-sorted rows
    over ``num_experts`` groups to K9's decode kernel: when they average
    at most ``DECODE_ROWS_PER_EXPERT`` rows a group (static shapes)."""
    return rows <= DECODE_ROWS_PER_EXPERT * num_experts


def moe_group_matmul(tokens: torch.Tensor, weights: torch.Tensor,
                     group_sizes: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
    """tokens [T, K] sorted by expert; group_sizes int [E]; weights
    [E, K, N] -> out f32 [T, N] through K9 (its plain version with
    ``plain=True`` or for CPU tensors).

    Pads the groups to ``M_TILE`` (:func:`moe_group_pad`) and K/N to
    multiples of 128 (zero rows and columns compute zeros); K9 skips the
    tiles past the real padded length. Few rows per expert
    (:func:`takes_decode_kernel`, a decode step) take K9's decode kernel,
    which multiplies only each tile's real rows; the others the tiled
    kernel."""
    T, K = tokens.shape
    E, K2, N = weights.shape
    if K2 != K or group_sizes.shape != (E,):
        raise ValueError(f"tokens {tuple(tokens.shape)}, weights "
                         f"{tuple(weights.shape)} and group_sizes "
                         f"{tuple(group_sizes.shape)} do not fit")
    Kp = -(-K // _moe.K_TILE) * _moe.K_TILE
    Np = -(-N // _moe.N_TILE) * _moe.N_TILE
    if (Kp, Np) != (K, N):
        weights = torch.nn.functional.pad(weights,
                                          (0, Np - N, 0, Kp - K))
    weights = weights.contiguous()
    g = moe_group_pad(tokens, group_sizes, E, Kp)
    if plain:
        out_pad = _moe.moe_group_matmul_padded_plain(
            g.lhs, weights, g.tile_expert, n_rows=g.n_rows,
            tile_rows=g.tile_rows)
    elif takes_decode_kernel(T, E):
        out_pad = _moe.moe_group_matmul_decode(
            g.lhs, weights, g.tile_expert, g.tile_rows, n_rows=g.n_rows)
    else:
        out_pad = _moe.moe_group_matmul_padded(g.lhs, weights,
                                               g.tile_expert,
                                               n_rows=g.n_rows)
    return out_pad[g.pos, :N]
