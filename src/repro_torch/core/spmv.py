"""SpMV (paper §2-§4): torch oracles and the ``spmv`` dispatch.

Every storage format lowers to the same contraction y[r] += v * x[c]. The
oracles below run on CPU and CUDA; the kernel paths live in
``repro_torch.kernels`` (merge-path CSR, K4) and ``repro_torch.spmm``
(SELL-C-σ, K1).
"""
from __future__ import annotations

from typing import Union

import torch

from .formats import COO, CSR

Matrix = Union[COO, CSR]


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


def spmv(mat, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Multiply ``y = A x``. impl in {"auto", "ref", "kernel", "plain"}:
    "kernel" launches the CUDA kernel for CSR (merge-path, K4) and
    SELL-C-σ (K1) and needs CUDA tensors; "plain" runs their plain
    PyTorch versions; "auto" takes the kernel for CUDA tensors and the
    oracle on the CPU."""
    from repro_torch.spmm import resolve_impl
    from repro_torch.spmm.sellcs import SellCS   # late import: core <- spmm
    impl = resolve_impl(impl, x.device)
    if impl in ("kernel", "plain"):
        if impl == "kernel" and x.device.type != "cuda":
            raise ValueError("impl='kernel' needs CUDA tensors; use "
                             "impl='plain' on the CPU")
        plain = impl == "plain"
        if isinstance(mat, CSR):
            from repro_torch.kernels import ops as kops
            return kops.merge_spmv(mat, x, plain=plain)
        if isinstance(mat, SellCS):
            from repro_torch.spmm.kernels import sellcs_spmm
            return sellcs_spmm(mat, x[:, None], plain=plain)[:, 0]
        raise TypeError(f"no kernel path for {type(mat).__name__}")
    if isinstance(mat, SellCS):
        from repro_torch.spmm.reference import spmm_sellcs
        return spmm_sellcs(mat, x)
    if isinstance(mat, COO):
        return spmv_coo(mat, x)
    if isinstance(mat, CSR):
        return spmv_csr(mat, x)
    raise TypeError(f"unknown matrix type {type(mat).__name__}")
