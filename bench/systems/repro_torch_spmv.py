"""The system ``repro_torch_spmv`` (a configuration's ``system``): the port
entered as ``serve --mode spmv`` enters it, the port's ``to_coo``, a
``SparseOperator`` built by ``from_coo`` with the configuration's
``PlanSpec``, fronted by a ``RequestBatcher`` whose ``spmm_fn`` is the
operator's ``matmul``.

A system module exports ``System(config, triplets, device)``, with
``convert_s``, ``batcher(annotate=False)`` (``submit``, ``pending``,
``flush``), ``spans()`` and ``close()``. The modules under ``systems/``
are the benchmark's only ones that import the program (``repro_torch``);
the reference and the yardstick import none of it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch

SPANS = ("batcher/pad", "batcher/multiply")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PortSystem:
    """The operator of one configuration over the benchmark's triplets.
    ``convert_s`` is the port's conversion: ``to_coo`` and
    ``SparseOperator.from_coo``, ended by a device synchronise."""

    def __init__(self, config: dict, triplets, device: torch.device,
                 impl: str = "auto"):
        from repro_torch.core import PlanSpec
        from repro_torch.core.convert import to_coo
        from repro_torch.spmm import SparseOperator
        if config.get("dtype", "float32") != "float32":
            raise ValueError("the port serves float32 requests only")
        rows, cols, vals, shape = triplets
        self.config = config
        self.device = device
        t0 = time.perf_counter()
        coo = to_coo(rows, cols, vals, shape, device=device)
        self.op = SparseOperator.from_coo(
            coo, PlanSpec(num_devices=1, algorithm=config["algorithm"]),
            impl=impl, k_hint=config["max_batch"])
        _sync(device)
        self.convert_s = time.perf_counter() - t0

    def batcher(self, annotate: bool = False):
        """A fresh ``RequestBatcher`` over the operator; with ``annotate``
        its multiply runs inside the profiler range ``bench/multiply``."""
        from repro_torch.spmm import RequestBatcher
        op = self.op
        if annotate:
            def spmm_fn(_m, X):
                with torch.profiler.record_function("bench/multiply"):
                    return op.matmul(X)
        else:
            def spmm_fn(_m, X):
                return op.matmul(X)
        return RequestBatcher(op, max_batch=self.config["max_batch"],
                              pad_pow2=self.config["pad_pow2"],
                              spmm_fn=spmm_fn)

    @contextlib.contextmanager
    def spans(self):
        """Installs a registry of the program's ``obs`` for the block and
        fills the yielded dict with ``{span: (count, mean seconds)}`` of
        the batcher's pad and multiply spans when it ends."""
        from repro_torch import obs
        out: Dict[str, Tuple[int, float]] = {}
        reg = obs.install(obs.MetricRegistry(mode="bench"))
        try:
            yield out
        finally:
            obs.uninstall()
        for h in reg.histograms():
            if h.name in SPANS and h.count:
                out[h.name] = (h.count, h.mean)

    def close(self) -> None:
        """Drops the program's state so that the reference has the card."""
        self.op = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


System = PortSystem
