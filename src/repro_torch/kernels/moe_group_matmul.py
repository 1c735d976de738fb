"""Grouped (expert-blocked) GEMM for MoE dispatch — K9.

:func:`moe_group_matmul_padded` replaces
``repro.kernels.moe_group_matmul.moe_group_matmul_padded`` / ``_kernel``:
lhs [T_pad, K] holds the tokens sorted by expert with every group padded
to ``M_TILE`` rows, and for each ``M_TILE``-row m-tile ``i``

    out[i*128 : +128, :] = lhs[i*128 : +128, :] @ rhs[tile_expert[i]]

with every lhs and rhs value taken to float32 exactly, float32 products
and sums, and the float32 result cast to ``out_dtype`` (float32 by
default), as the reference's ``acc.astype(out_dtype)`` flushes it. lhs
is float32 or bfloat16; rhs is float32, or bfloat16 or float16, which
the wrapper widens to float32 (exactly). It is CUDA C++ in
``repro_torch/csrc/moe_group_matmul.cu`` (see its notes for the bound and
the design). The wrapper runs the plain PyTorch version
(:func:`moe_group_matmul_padded_plain`) only for CPU tensors; a CUDA
tensor launches the kernel or raises. Launches are counted in
``moe_group_matmul_padded.launches``.

:func:`moe_group_matmul_decode` computes the same function with a second
kernel for tiles that hold few real rows (a decode step): it multiplies
only each tile's real rows, and its sums are bitwise those of the tiled
kernel. Its launches are counted in
``moe_group_matmul_decode.launches``; ``kernels.ops.moe_group_matmul``
picks it from the shapes.

``n_rows`` (optional, an int32 tensor of one element on lhs's device) is
the real padded length, ``padded_ptr[E]`` in ``kernels.ops``: m-tiles
that start at or past it are zero in the output and cost the kernel no
product. ``tile_rows`` (int32 [T_pad / 128] on lhs's device; optional
for the tiled kernel, required for the decode kernel) is the number of
real rows of each m-tile (``kernels.ops.moe_group_pad``): output rows
past it are zero. Both stay on the device, so no host sync is needed.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _lib

M_TILE, N_TILE, K_TILE = 128, 128, 128

# lhs dtype -> the code the C entry point takes
_LHS_CODE = {torch.float32: 0, torch.bfloat16: 1}
# rhs dtypes the wrapper takes; the kernel reads float32, so the others
# are widened to it first (exact)
_RHS_WIDENED = (torch.float32, torch.bfloat16, torch.float16)

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


def _zero_dead_rows(out: torch.Tensor, tile_rows: torch.Tensor
                    ) -> torch.Tensor:
    """``out`` [nm, 128, N] with the rows past each tile's real count
    zero."""
    keep = torch.arange(M_TILE, device=out.device)[None, :] \
        < tile_rows.to(device=out.device, dtype=torch.int64)[:, None]
    return torch.where(keep[:, :, None], out, 0.0)


def moe_group_matmul_padded_plain(lhs: torch.Tensor, rhs: torch.Tensor,
                                  tile_expert: torch.Tensor, *,
                                  n_rows: Optional[torch.Tensor] = None,
                                  tile_rows: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The function K9 computes, in plain PyTorch: each m-tile's
    (128, K) @ (K, N) product in float32 with the weights of its expert
    (ids clamped to [0, E), as the reference's gathers clamp), tiles at or
    past ``n_rows`` and rows past ``tile_rows`` zero -> f32 [T_pad, N]."""
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
    if tile_rows is not None:
        if tile_rows.shape != (nm,):
            raise ValueError(f"tile_rows must have {nm} entries, got "
                             f"{tuple(tile_rows.shape)}")
        out = _zero_dead_rows(out, tile_rows)
    return out.view(T_pad, N)


def _card_operands(lhs: torch.Tensor, rhs: torch.Tensor,
                   tile_expert: torch.Tensor, n_rows: Optional[torch.Tensor],
                   tile_rows: Optional[torch.Tensor]):
    """Validate K9's operands on the card -> ``(head, tail, out, rhs)``: the
    C entry points' arguments before and after the tile counts, the f32
    [T_pad, N] output and the f32 weights they point to (held by the
    caller until the launch)."""
    T_pad, K, E, N = _check_shapes(lhs, rhs, tile_expert)
    rhs = rhs.to(torch.float32)                  # exact for bf16 and f16
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
    if tile_rows is not None:
        _lib.require(tile_rows, "tile_rows", torch.int32, 1)
        if tile_rows.shape != tile_expert.shape \
                or tile_rows.device != lhs.device:
            raise ValueError(f"tile_rows must be int32 [{T_pad // M_TILE}]"
                             " on lhs's device")
    out = torch.empty((T_pad, N), dtype=torch.float32, device=lhs.device)
    head = (lhs.data_ptr(), lhs_code, rhs.data_ptr(), tile_expert.data_ptr(),
            0 if n_rows is None else n_rows.data_ptr())
    tail = (out.data_ptr(), T_pad, K, N, E, _lib.stream_of(lhs))
    return head, tail, out, rhs


def _check_dtypes(rhs: torch.Tensor, out_dtype) -> None:
    if not out_dtype.is_floating_point:
        raise TypeError(f"out_dtype must be a float dtype, got {out_dtype}")
    if rhs.dtype not in _RHS_WIDENED:
        raise TypeError(f"rhs must be one of {_RHS_WIDENED}, got "
                        f"{rhs.dtype}")


def moe_group_matmul_padded(lhs: torch.Tensor, rhs: torch.Tensor,
                            tile_expert: torch.Tensor, *,
                            out_dtype=torch.float32,
                            n_rows: Optional[torch.Tensor] = None,
                            tile_rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K9: the grouped GEMM over expert-sorted, group-padded rows.
    lhs f32/bf16 [T_pad, K], rhs f32/bf16/f16 [E, K, N], tile_expert
    int32 [T_pad / 128] (, n_rows int32 [1], tile_rows int32
    [T_pad / 128]) -> out_dtype [T_pad, N] (the kernel writes float32;
    another float dtype is a cast of it)."""
    _check_dtypes(rhs, out_dtype)
    if lhs.device.type == "cpu":
        out = moe_group_matmul_padded_plain(lhs, rhs, tile_expert,
                                            n_rows=n_rows,
                                            tile_rows=tile_rows)
        return out.to(out_dtype)
    head, tail, out, rhs = _card_operands(lhs, rhs, tile_expert, n_rows,
                                          tile_rows)
    fn = "moe_group_matmul_launch"
    _lib.check(_lib.entry(fn)(*head, *tail), fn)
    moe_group_matmul_padded.launches += 1
    if tile_rows is not None:        # not on the prefill path: no cost there
        out = _zero_dead_rows(out.view(-1, M_TILE, out.shape[1]),
                              tile_rows).view(out.shape)
    return out.to(out_dtype)


moe_group_matmul_padded.launches = 0


def moe_group_matmul_decode(lhs: torch.Tensor, rhs: torch.Tensor,
                            tile_expert: torch.Tensor,
                            tile_rows: torch.Tensor, *,
                            out_dtype=torch.float32,
                            n_rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """K9 for tiles with few real rows: the function of
    :func:`moe_group_matmul_padded` given ``tile_rows``, through the decode
    kernel, which multiplies only each tile's real rows (bitwise the
    tiled kernel's sums on them). The plain version on CPU tensors."""
    _check_dtypes(rhs, out_dtype)
    if tile_rows is None:
        raise ValueError("the decode kernel needs the tiles' row counts")
    if lhs.device.type == "cpu":
        out = moe_group_matmul_padded_plain(lhs, rhs, tile_expert,
                                            n_rows=n_rows,
                                            tile_rows=tile_rows)
        return out.to(out_dtype)
    head, tail, out, rhs = _card_operands(lhs, rhs, tile_expert, n_rows,
                                          tile_rows)
    fn = "moe_group_matmul_decode_launch"
    _lib.check(_lib.entry(fn)(*head, tile_rows.data_ptr(), *tail), fn)
    moe_group_matmul_decode.launches += 1
    return out.to(out_dtype)


moe_group_matmul_decode.launches = 0
