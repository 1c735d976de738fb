"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper
card (H100).

The module layout mirrors ``repro`` one to one: ``repro_torch.spmm.kernels``
is the counterpart of ``repro.spmm.kernels`` and so on. Storage formats are
plain dataclasses holding tensors on an explicit device; conversions run on
the host in numpy (as in the JAX package) and move their results to that
device once.

This first slice carries the single-device SpMV serving path:

``core``       ``COO``/``CSR`` storage, the flat conversions, merge-path
               partitioning, the ``spmv`` dispatch and the §7 selector
``data``       the synthetic matrix generators (numpy, bit-identical
               triplets to ``repro.data.matrices`` for the same seed)
``spmm``       SELL-C-σ storage, torch oracles, the CUDA kernel wrappers
               (``kernels``), the ``spmm`` dispatcher, ``SparseOperator``
               and ``RequestBatcher``
``kernels``    the merge-path SpMV kernel and the shared build of the
               CUDA sources in ``csrc/``
``roofline``   the SpMM traffic model with H100 constants
``obs``        metrics registry, phase spans, residual ledger, min-of-N
``launch``     ``python -m repro_torch.launch.serve --mode spmv``
``interop``    the JAX package's storage (as numpy dicts) -> port objects

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports no ``jax`` and nothing of ``repro``.
"""
__version__ = "0.1.0"

__all__ = ["core", "data", "spmm", "kernels", "roofline", "obs", "launch",
           "interop"]
