"""Grouped (expert-blocked) GEMM for MoE dispatch — K9.

:func:`moe_group_matmul_padded` replaces
``repro.kernels.moe_group_matmul.moe_group_matmul_padded`` / ``_kernel``:
lhs [T_pad, K] holds the tokens sorted by expert with every group padded
to ``M_TILE`` rows, and for each ``M_TILE``-row m-tile ``i``

    out[i*128 : +128, :] = lhs[i*128 : +128, :] @ rhs[tile_expert[i]]

with every lhs value taken to float32 exactly, float32 products and sums,
and a float32 result (the reference's default ``out_dtype``, the only
one its callers use; another raises). It is CUDA C++ in
``repro_torch/csrc/moe_group_matmul.cu`` (see its notes for the bound and
the design). The wrapper runs the plain PyTorch version
(:func:`moe_group_matmul_padded_plain`) only for CPU tensors; a CUDA
tensor launches the kernel or raises. Launches are counted in
``moe_group_matmul_padded.launches``.

``n_rows`` (optional, an int32 tensor of one element on lhs's device) is
the real padded length, ``padded_ptr[E]`` in ``kernels.ops``: m-tiles
that start at or past it are zero in the output and cost the kernel no
product. It stays on the device, so no host sync is needed.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib

M_TILE, N_TILE, K_TILE = 128, 128, 128

# lhs dtype -> the code the C entry point takes
_LHS_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the plain version multiplies this many m-tiles per batched product, so
# its gathered weights stay near 64 MiB at the widths of the full configs
_PLAIN_TILES = 16


def _check_shapes(lhs: torch.Tensor, rhs: torch.Tensor,
                  tile_expert: torch.Tensor):
    if lhs.ndim != 2 or rhs.ndim != 3 or tile_expert.ndim != 1:
        raise ValueError(f"lhs must be [T_pad, K], rhs [E, K, N] and "
                         f"tile_expert [T_pad/{M_TILE}]; got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}, "
                         f"{tuple(tile_expert.shape)}")
    T_pad, K = lhs.shape
    E, K2, N = rhs.shape
    if K != K2 or T_pad % M_TILE or K % K_TILE or N % N_TILE:
        raise ValueError(f"need K == K2, T_pad % {M_TILE} == 0, K % "
                         f"{K_TILE} == 0 and N % {N_TILE} == 0; got lhs "
                         f"{tuple(lhs.shape)}, rhs {tuple(rhs.shape)}")
    if tile_expert.shape[0] != T_pad // M_TILE:
        raise ValueError(f"tile_expert must have {T_pad // M_TILE} "
                         f"entries, got {tile_expert.shape[0]}")
    if E < 1:
        raise ValueError("rhs must hold at least one expert")
    return T_pad, K, E, N


def moe_group_matmul_padded_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                                  tile_expert: torch.Tensor, *,
                                  n_rows: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The function K9 computes, in plain PyTorch: each m-tile's
    (128, K) @ (K, N) product in float32 with the weights of its expert
    (ids clamped to [0, E), as the reference's gathers clamp), tiles at or
    past ``n_rows`` zero -> f32 [T_pad, N]."""
    T_pad, K, E, N = _check_shapes(lhs, rhs, tile_expert)
    nm = T_pad // M_TILE
    te = tile_expert.long().clamp(0, E - 1)
    a = lhs.to(torch.float32).view(nm, M_TILE, K)
    out = torch.empty((nm, M_TILE, N), dtype=torch.float32,
                      device=lhs.device)
    for t0 in range(0, nm, _PLAIN_TILES):
        sl = slice(t0, min(t0 + _PLAIN_TILES, nm))
        torch.bmm(a[sl], rhs[te[sl]].to(torch.float32), out=out[sl])
    if n_rows is not None:
        live = torch.arange(nm, device=lhs.device) * M_TILE \
            < n_rows.reshape(()).to(lhs.device)
        out = torch.where(live[:, None, None], out, 0.0)
    return out.view(T_pad, N)


def moe_group_matmul_padded(lhs: torch.Tensor, rhs: torch.Tensor,
                            tile_expert: torch.Tensor, *,
                            out_dtype=torch.float32,
                            n_rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K9: the grouped GEMM over expert-sorted, group-padded rows.
    lhs f32/bf16 [T_pad, K], rhs f32 [E, K, N], tile_expert int32
    [T_pad / 128] (, n_rows int32 [1]) -> f32 [T_pad, N]."""
    if out_dtype != torch.float32:
        raise TypeError(f"K9 writes float32 only, got out_dtype {out_dtype}")
    if lhs.device.type == "cpu":
        return moe_group_matmul_padded_plain(lhs, rhs, tile_expert,
                                             n_rows=n_rows)
    T_pad, K, E, N = _check_shapes(lhs, rhs, tile_expert)
    lhs_code = _LHS_CODE.get(lhs.dtype)
    if lhs_code is None:
        raise TypeError(f"lhs must be one of {tuple(_LHS_CODE)}, got "
                        f"{lhs.dtype}")
    _lib.require(lhs, "lhs", lhs.dtype, 2)
    _lib.require(rhs, "rhs", torch.float32, 3)
    _lib.require(tile_expert, "tile_expert", torch.int32, 1)
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        if t.device != lhs.device:
            raise ValueError(f"{name} is on {t.device}, lhs on "
                             f"{lhs.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if tile_expert.device != lhs.device:
        raise ValueError("tile_expert must be on lhs's device")
    if n_rows is not None:
        _lib.require(n_rows, "n_rows", torch.int32, 1)
        if n_rows.numel() != 1 or n_rows.device != lhs.device:
            raise ValueError("n_rows must be one int32 on lhs's device")
    if T_pad // M_TILE > 65535:
        raise ValueError(f"T_pad {T_pad} exceeds the grid's "
                         f"{65535 * M_TILE} rows")
    out = torch.empty((T_pad, N), dtype=torch.float32, device=lhs.device)
    fn = "moe_group_matmul_launch"
    _lib.check(_lib.entry(fn)(
        lhs.data_ptr(), lhs_code, rhs.data_ptr(), tile_expert.data_ptr(),
        0 if n_rows is None else n_rows.data_ptr(), out.data_ptr(), T_pad,
        K, N, E, _lib.stream_of(lhs)), fn)
    moe_group_matmul_padded.launches += 1
    return out


moe_group_matmul_padded.launches = 0
