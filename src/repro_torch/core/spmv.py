"""SpMV (paper §2-§4): torch oracles and the ``spmv`` dispatch.

Every storage format lowers to the same contraction y[r] += v * x[c]; what
the paper's nine algorithms change is storage layout, traversal order and
scheduling. The oracles below run on CPU and CUDA; the kernel paths live in
``repro_torch.kernels`` (merge-path CSR, K4; the tiled blocked formats, K5)
and ``repro_torch.spmm`` (SELL-C-σ, K1).
"""
from __future__ import annotations

from typing import Union

import torch

from .formats import BICRS, COO, CSR, ICRS, BlockedSparse

Matrix = Union[COO, CSR, ICRS, BICRS, BlockedSparse]


def spmv_coo(coo: COO, x: torch.Tensor) -> torch.Tensor:
    """Triplet-format SpMV (paper §2): y[row[i]] += data[i] * x[col[i]]."""
    m, _ = coo.shape
    dtype = torch.promote_types(coo.data.dtype, x.dtype)
    y = torch.zeros(m, dtype=dtype, device=x.device)
    if coo.nnz == 0:
        return y
    return y.index_add_(0, coo.rows.long(),
                        coo.data.to(dtype) * x.to(dtype)[coo.cols.long()])


def spmv_csr(csr: CSR, x: torch.Tensor) -> torch.Tensor:
    """CRS SpMV (Algorithm 2.1): decompress rows + one segment reduction."""
    m, _ = csr.shape
    dtype = torch.promote_types(csr.data.dtype, x.dtype)
    y = torch.zeros(m, dtype=dtype, device=x.device)
    if csr.nnz == 0:
        return y
    prod = csr.data.to(dtype) * x.to(dtype)[csr.col_ind.long()]
    return y.index_add_(0, csr.row_of_nnz().long(), prod)


def spmv_incremental(mat: ICRS, x: torch.Tensor) -> torch.Tensor:
    """Algorithm 2.2 for the (B)ICRS encodings: the increments are decoded
    (sequentially, on the host) into (row, col) and the products are
    added in the stored order. The oracle of the incremental encodings."""
    return spmv_coo(mat.to_coo(), x)


def spmv_blocked(bs: BlockedSparse, x: torch.Tensor) -> torch.Tensor:
    """Blocked-format SpMV: decode (block, local) -> global coordinates,
    gather/FMA, scatter-add, in storage order (the row / Morton / Hilbert
    traversal of the format)."""
    m, _ = bs.shape
    dtype = torch.promote_types(bs.data.dtype, x.dtype)
    y = torch.zeros(m, dtype=dtype, device=x.device)
    if bs.nnz == 0:
        return y
    rows, cols = bs.global_rows_cols()
    return y.index_add_(0, rows, bs.data.to(dtype) * x.to(dtype)[cols])


def spmv_dense_oracle(mat: Matrix, x: torch.Tensor) -> torch.Tensor:
    """Densify + matmul. Only for small test matrices."""
    coo = mat if isinstance(mat, COO) else mat.to_coo()
    dense = coo.todense()
    dtype = torch.promote_types(dense.dtype, x.dtype)
    return dense.to(dtype) @ x.to(dtype)


def spmv(mat, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Multiply ``y = A x``. impl in {"auto", "ref", "kernel", "plain"}:
    "kernel" launches the CUDA kernel for CSR (merge-path, K4), SELL-C-σ
    (K1) and the tiled blocked formats (K5) and needs CUDA tensors;
    "plain" runs their plain PyTorch versions; "auto" takes the kernel for
    CUDA tensors of a format that has one and the oracle otherwise."""
    from repro_torch.kernels.tiling import TiledSparse
    from repro_torch.spmm import resolve_impl
    from repro_torch.spmm.sellcs import SellCS   # late import: core <- spmm
    if impl == "auto" and not isinstance(mat, (CSR, SellCS, TiledSparse)):
        impl = "ref"
    impl = resolve_impl(impl, x.device)
    if impl in ("kernel", "plain"):
        if impl == "kernel" and x.device.type != "cuda":
            raise ValueError("impl='kernel' needs CUDA tensors; use "
                             "impl='plain' on the CPU")
        plain = impl == "plain"
        from repro_torch.kernels import ops as kops
        if isinstance(mat, TiledSparse):
            return kops.bsr_spmv(mat, x, plain=plain)
        if isinstance(mat, CSR):
            return kops.merge_spmv(mat, x, plain=plain)
        if isinstance(mat, SellCS):
            from repro_torch.spmm.kernels import sellcs_spmm
            return sellcs_spmm(mat, x[:, None], plain=plain)[:, 0]
        raise TypeError(
            f"no kernel path for {type(mat).__name__}; convert with "
            "repro_torch.kernels.coo_to_tiled for the blocked kernel")
    if isinstance(mat, TiledSparse):
        from repro_torch.kernels.ref import bsr_spmv_ref
        return bsr_spmv_ref(mat, x)
    if isinstance(mat, SellCS):
        from repro_torch.spmm.reference import spmm_sellcs
        return spmm_sellcs(mat, x)
    if isinstance(mat, COO):
        return spmv_coo(mat, x)
    if isinstance(mat, CSR):
        return spmv_csr(mat, x)
    if isinstance(mat, ICRS):            # BICRS too
        return spmv_incremental(mat, x)
    if isinstance(mat, BlockedSparse):
        return spmv_blocked(mat, x)
    raise TypeError(f"unknown matrix type {type(mat).__name__}")
