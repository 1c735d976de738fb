"""Phase-level tracing: ``span("gather_x")`` wraps a code region, records
its host wall time into the installed registry's histograms, and names the
region in profiler traces — ``torch.profiler.record_function`` (so a
``torch.profiler`` capture shows it on the host timeline) and, on CUDA, an
NVTX range — where the reference uses ``jax.named_scope`` /
``jax.profiler.TraceAnnotation``.

Nesting builds slash-joined paths: a ``span("multiply")`` opened inside
``span("flush")`` records into the ``"flush/multiply"`` histogram. A name
that already contains a ``/`` is absolute: it records under exactly that
path and neither joins nor extends the enclosing stack.

CUDA launches are asynchronous: a span around launch-only code would time
the enqueue. ``maybe_block`` closes a span honestly — it synchronizes the
current CUDA device when (and only when) a registry is installed and the
value lives on a CUDA device.

Zero-overhead default: with no registry installed ``span()`` returns a
process-wide singleton whose ``__enter__``/``__exit__`` do nothing — no
allocation, no perf_counter call, no profiler call.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from . import metrics as _metrics


class _NullSpan:
    """The disabled path: a shared, stateless, allocation-free context
    manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

_STACK = threading.local()


def _stack():
    s = getattr(_STACK, "names", None)
    if s is None:
        s = _STACK.names = []
    return s


class _Span:
    """An enabled span: perf_counter + record_function (+ NVTX on CUDA)."""
    __slots__ = ("name", "registry", "labels", "path", "_t0", "_rf",
                 "_nvtx", "_pushed")

    def __init__(self, name, registry, labels):
        self.name = name
        self.registry = registry
        self.labels = labels
        self.path = None
        self._t0 = 0.0
        self._rf = None
        self._nvtx = False
        self._pushed = False

    def __enter__(self):
        if "/" in self.name:            # absolute: stable series name
            self.path = self.name
        else:
            stack = _stack()
            stack.append(self.name)
            self._pushed = True
            self.path = "/".join(stack)
        self._rf = torch.profiler.record_function(self.path)
        self._rf.__enter__()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(self.path)
            self._nvtx = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(exc_type, exc, tb)
        if self._pushed:
            stack = _stack()
            if stack and stack[-1] == self.name:
                stack.pop()
        # record even on exception: a phase that died still spent the time
        self.registry.histogram(self.path, self.labels).observe(dt)
        return False


def span(name: str, registry=None, labels: Optional[dict] = None):
    """Context manager timing one named phase (free when no registry is
    installed and none is passed)."""
    reg = registry if registry is not None else _metrics._REGISTRY
    if reg is None:
        return _NULL_SPAN
    return _Span(name, reg, labels)


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device.type == "cuda"
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    return False


def maybe_block(x):
    """Synchronize the current CUDA device iff a registry is installed and
    ``x`` holds a CUDA tensor, so the enclosing span times execution.
    Returns ``x``. The disabled path is one global load."""
    if _metrics._REGISTRY is None:
        return x
    if _on_cuda(x):
        torch.cuda.synchronize()
    return x
