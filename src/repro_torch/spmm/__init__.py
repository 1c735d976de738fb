"""repro_torch.spmm — the multi-RHS SpMM engine (``Y = A @ X``).

Layers (one module each, mirroring ``repro.spmm``):

  ``sellcs``     SELL-C-σ storage
  ``reference``  pure-torch oracles per format (``impl="ref"``)
  ``kernels``    the CUDA kernel wrappers K1 (SELL-C-σ) and K2 (merge CSR)
  ``batching``   request batching for the serve path (k SpMVs -> 1 SpMM)
  ``operator``   SparseOperator: the partition-once/multiply-many handle
                 with an atomic plan swap (online format migration)

SpMV is the k = 1 special case throughout; ``repro_torch.core.spmv`` is
the single-vector entry point.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import COO, CSR
from . import reference
from .batching import RequestBatcher, SpmvRequest, batch_spmv
from .kernels import choose_k_tile, csr_spmm, sellcs_spmm
from .operator import (OperatorStats, RealizedPlan, SparseOperator,
                       coo_fingerprint)
from .reference import (TRANSPOSE_SLICE, spmm_coo, spmm_csr, spmm_ref,
                        spmm_sellcs)
from .sellcs import SellCS, coo_to_sellcs

IMPLS = ("auto", "ref", "kernel", "plain")


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"auto"`` is the kernel for CUDA tensors and the oracle on the
    CPU; every other value must be one of :data:`IMPLS`."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "kernel" if device.type == "cuda" else "ref"
    return impl


def spmm(mat, x: torch.Tensor, *, impl: str = "auto",
         k_tile: Optional[int] = None, op: str = "N") -> torch.Tensor:
    """Multiply ``Y = A @ X`` for any supported format.

    ``impl`` in {"auto", "ref", "kernel", "plain"}: "kernel" launches the
    CUDA kernels and needs CUDA tensors (the counterpart of the
    reference's "pallas"); "plain" runs the kernels' plain PyTorch
    versions through the same padding and unpermute code (the counterpart
    of "pallas_interpret"); "ref" is the oracle; "auto" takes the kernel
    for CUDA tensors and the oracle on the CPU. The kernel paths return
    float32; the oracle returns ``promote_types(data, x)``."""
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    impl = resolve_impl(impl, x.device)
    if impl == "ref":
        return spmm_ref(mat, x, op=op)
    if op == "T":
        raise NotImplementedError(TRANSPOSE_SLICE)
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError("impl='kernel' needs CUDA tensors; use "
                         "impl='plain' for the plain versions on the CPU")
    plain = impl == "plain"
    x2 = x[:, None] if x.ndim == 1 else x
    if isinstance(mat, CSR):
        y = csr_spmm(mat, x2, k_tile=k_tile, plain=plain)
    elif isinstance(mat, SellCS):
        y = sellcs_spmm(mat, x2, k_tile=k_tile, plain=plain)
    else:
        raise TypeError(f"no SpMM kernel for {type(mat).__name__}; convert "
                        "with coo_to_sellcs / coo_to_csr")
    return y[:, 0] if x.ndim == 1 else y


__all__ = [
    "SellCS", "coo_to_sellcs", "spmm", "resolve_impl", "IMPLS",
    "choose_k_tile", "csr_spmm", "sellcs_spmm",
    "spmm_ref", "spmm_coo", "spmm_csr", "spmm_sellcs", "reference",
    "RequestBatcher", "SpmvRequest", "batch_spmv",
    "SparseOperator", "RealizedPlan", "OperatorStats", "coo_fingerprint",
    "COO", "CSR",
]
