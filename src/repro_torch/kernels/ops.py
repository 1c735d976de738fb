"""Public wrappers around the single-vector and tiled kernels.

``plain=True`` runs the kernels' plain PyTorch versions on any device (the
counterpart of the reference's ``interpret=True``); otherwise a CUDA tensor
launches the CUDA kernels and a CPU tensor takes the plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import CSR
from . import bsr_spmv as _bsr
from . import merge_spmv as _merge
from .tiling import TiledSparse


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
