"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA Hopper
card (H100).

The module layout mirrors ``repro`` one to one: ``repro_torch.spmm.kernels``
is the counterpart of ``repro.spmm.kernels`` and so on. Storage formats are
plain dataclasses holding tensors on an explicit device; conversions run on
the host in numpy (as in the JAX package) and move their results to that
device once.

The ported slices carry single-device SpMV serving, the transpose path,
the paper's blocked formats, the multi-device schedules, the fleet and
the autotuner, LM serving (attention, Mamba-2 and hybrid stacks) and
single-device LM training:

``core``       ``COO``/``CSR``/``ICRS``/``BICRS``/``BlockedSparse`` storage
               and their conversions for all nine paper algorithms, the
               space-filling curves, merge-path partitioning, the ``spmv``
               dispatch and the §7 selector
``data``       the synthetic matrix generators (numpy, bit-identical
               triplets to ``repro.data.matrices`` for the same seed) and
               the step-keyed token pipeline
``spmm``       SELL-C-σ storage, torch oracles, the CUDA kernel wrappers
               (``kernels``), the ``spmm`` dispatcher, ``SparseOperator``
               and ``RequestBatcher``
``kernels``    the merge-path SpMV kernel, the tiled compute format of the
               blocked algorithms (``TiledSparse``) with its kernels, the
               MoE grouped GEMM (K9) and the shared build of the CUDA
               sources in ``csrc/``
``roofline``   the SpMM traffic model with H100 constants
``obs``        metrics registry, phase spans, residual ledger, min-of-N
``configs``    the architecture configs (data) and the shape registry
``models``     the decoder LM: attention with KV caches, the Mamba-2 SSM
               mixer, the MoE layer over the grouped-GEMM kernel K9,
               prefill and decode, the training loss, the parameter
               accounting
``optim``      AdamW, Adafactor and the learning-rate schedules
``checkpoint`` atomic checkpoints with async flush and retention
``runtime``    the train loop's ``Supervisor``, straggler monitoring, the
               elastic shrink policy
``launch``     ``python -m repro_torch.launch.serve --mode spmv|lm|fleet``,
               ``python -m repro_torch.launch.train``, the step builders
               and the device mesh
``examples``   ``quickstart``, ``spmv_tour``, ``gmres``, ``pagerank``,
               ``serve_lm``, ``train_lm`` and ``kernel_profile``
``interop``    the JAX package's storage and LM parameters (as numpy)
               -> port objects

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports no ``jax`` and nothing of ``repro``.
"""
__version__ = "0.1.0"

__all__ = ["core", "data", "spmm", "kernels", "roofline", "obs", "configs",
           "models", "optim", "checkpoint", "runtime", "launch", "examples",
           "interop"]
