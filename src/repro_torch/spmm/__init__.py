"""repro_torch.spmm — the multi-RHS SpMM engine (``Y = A @ X``).

Layers (one module each, mirroring ``repro.spmm``):

  ``sellcs``     SELL-C-σ storage
  ``reference``  pure-torch oracles per format (``impl="ref"``)
  ``kernels``    the CUDA kernel wrappers K1 (SELL-C-σ), K8 (K1 with the
                 compact-X gather fused in), K3 (its transpose), K2 (merge
                 CSR) and K6 (the tiled blocked formats)
  ``distributed`` the row-band and merge-span schedules over a device mesh
  ``batching``   request batching for the serve path (k SpMVs -> 1 SpMM)
  ``operator``   SparseOperator: the partition-once/multiply-many handle
                 with an atomic plan swap (online format migration), its
                 transpose view and the differentiable ``sparse_matmul``

SpMV is the k = 1 special case throughout; ``repro_torch.core.spmv`` is
the single-vector entry point.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import COO, CSR, BlockedSparse
from repro_torch.kernels.tiling import TiledSparse
from . import reference
from .batching import RequestBatcher, SpmvRequest, batch_spmv
from .distributed import (ShardedSellCS, partition_sellcs_nnz,
                          partition_sellcs_rows, rechunk_sellcs,
                          redeal_sellcs, spmm_merge_distributed,
                          spmm_row_distributed)
from .kernels import choose_k_tile, csr_spmm, sellcs_spmm, tiled_spmm
from .operator import (OperatorStats, RealizedPlan, SparseOperator,
                       TransposedOperator, coo_fingerprint, sparse_matmul)
from .reference import (spmm_blocked, spmm_coo, spmm_coo_t, spmm_csr,
                        spmm_ref, spmm_sellcs, spmm_sellcs_t)
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
    for CUDA tensors of a format that has one and the oracle otherwise.
    The kernel paths return float32; the oracle returns
    ``promote_types(data, x)``.

    The kernel formats are SELL-C-σ (K1), CSR (K2) and ``TiledSparse``
    (K6, column tile ``k_tile``); a ``BlockedSparse`` has only its oracle.

    ``op='T'`` computes ``Y = A^T X`` over the same stored stream
    (``X: [m, k]``, ``Y: [n, k]``); the kernel paths support it on
    SELL-C-σ (K3), the oracle on SELL-C-σ and COO. A symmetric
    one-triangle SELL-C-σ matrix accepts either op (``A^T == A``)."""
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    has_kernel = isinstance(mat, SellCS) or (
        isinstance(mat, (CSR, TiledSparse)) and op == "N")
    if impl == "auto" and not has_kernel:
        impl = "ref"
    impl = resolve_impl(impl, x.device)
    if impl == "ref":
        return spmm_ref(mat, x, op=op)
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError("impl='kernel' needs CUDA tensors; use "
                         "impl='plain' for the plain versions on the CPU")
    if op == "T" and not isinstance(mat, SellCS):
        raise TypeError(f"no transpose SpMM kernel for "
                        f"{type(mat).__name__}; convert with coo_to_sellcs")
    plain = impl == "plain"
    x2 = x[:, None] if x.ndim == 1 else x
    if isinstance(mat, TiledSparse):
        y = tiled_spmm(mat, x2, k_tile=k_tile, plain=plain)
    elif isinstance(mat, CSR):
        y = csr_spmm(mat, x2, k_tile=k_tile, plain=plain)
    elif isinstance(mat, SellCS):
        y = sellcs_spmm(mat, x2, k_tile=k_tile, plain=plain, op=op)
    else:
        raise TypeError(f"no SpMM kernel for {type(mat).__name__}; convert "
                        "with coo_to_sellcs / repro_torch.kernels."
                        "coo_to_tiled / coo_to_csr")
    return y[:, 0] if x.ndim == 1 else y


__all__ = [
    "SellCS", "coo_to_sellcs", "spmm", "resolve_impl", "IMPLS",
    "choose_k_tile", "csr_spmm", "sellcs_spmm", "tiled_spmm",
    "spmm_ref", "spmm_coo", "spmm_csr", "spmm_blocked", "spmm_sellcs",
    "spmm_sellcs_t",
    "spmm_coo_t", "reference",
    "RequestBatcher", "SpmvRequest", "batch_spmv",
    "ShardedSellCS", "partition_sellcs_rows", "partition_sellcs_nnz",
    "rechunk_sellcs", "redeal_sellcs",
    "spmm_row_distributed", "spmm_merge_distributed",
    "SparseOperator", "RealizedPlan", "OperatorStats", "coo_fingerprint",
    "TransposedOperator", "sparse_matmul",
    "COO", "CSR", "BlockedSparse", "TiledSparse",
]
