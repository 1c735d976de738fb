"""Operation counts of a torch program: the port's counterpart of
``repro.roofline.hlo_parse``.

The reference parses a compiled XLA program's HLO text and multiplies
each computation by the trip counts of the loops around it, because
``cost_analysis()`` visits a ``lax.scan`` body once. The port has no
compiled program to parse: its steps are Python over eager tensors. So
:class:`OpCounter` is a ``TorchDispatchMode`` that sees every aten op as
it runs (on ``meta`` tensors it allocates nothing and computes nothing,
so a full-width step can be counted on the CPU). Every pass of a Python
loop is counted as it runs: the count already holds what the reference's
multiplication by trip counts recovers, and no trip count is parsed.

Per op, the reference's rules:

  * dot flops = 2 * |output| * |contracted dims| (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv``, ``dot``, convolutions, and the fused
    attention ops by their two products);
  * elementwise flops = |output| (one per output element, as each XLA
    elementwise instruction counts; a fused torch op such as ``silu`` or
    ``_softmax`` counts once, where XLA would count its pieces);
  * bytes = operands + output of every op that moves data (views,
    reshapes and other metadata ops move none). Eager torch has no
    fusion, so where the reference counts a fusion's inputs and output
    once, the port counts each op's;
  * on ``meta`` tensors a loop whose passes are equal in shape runs its
    first pass only and counts it once for every pass
    (:func:`equal_passes`, :func:`equal_calls`: the mesh train step's
    data blocks and the expert-parallel dispatch's positions). Their ops
    cannot differ, so this is the reference's multiplication by a trip
    count. Running every pass instead counts the same flops and
    collectives and 0.7 % more bytes, but takes the counted step of
    granite-moe-1b-a400m x train_4k on 256 positions from 13 s to 317 s
    on one Xeon core. Every other loop runs every pass;
  * collectives, by kind, as the port's own mesh helpers record them
    (:func:`record_collective`: the expert-parallel dispatch's ``psum``,
    the mesh train step's weight gathers and gradient reductions), the
    bytes of each one's output, as the reference counts a collective's
    output shape. The copies that carry a collective out are not counted
    as ops (:func:`uncounted`).
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Callable, Dict, Iterator, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops that move no data: views, metadata, aliasing
_NO_DATA = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "slice", "select",
    "as_strided", "detach", "alias", "unsqueeze", "squeeze", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "diagonal", "unfold",
    "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "view_as_real", "view_as_complex", "sym_size",
    "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense",
    "set_", "resize_", "_has_compatible_shallow_copy_type", "size",
    "stride", "dim", "is_contiguous",
}

# one flop per output element
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "exp",
    "log", "tanh", "neg", "pow", "rsqrt", "sqrt", "where", "eq", "ne",
    "lt", "le", "gt", "ge", "logical_and", "logical_or", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "_to_copy",
    "floor", "ceil", "cos", "sin", "sigmoid", "expm1", "log1p",
    "remainder", "sign", "silu", "gelu", "relu", "masked_fill", "clamp",
    "clamp_min", "clamp_max", "reciprocal", "square", "logaddexp",
    "softplus", "_softmax", "_log_softmax", "silu_backward",
    "gelu_backward", "sigmoid_backward", "tanh_backward",
    "_softmax_backward_data", "_log_softmax_backward_data",
    "threshold_backward", "lerp", "addcmul", "addcdiv", "fill",
}

_SUSPENDED = [0]
_SCALE = [1.0]
_ACTIVE: List["OpCounter"] = []


@contextlib.contextmanager
def repeated(n: int) -> Iterator[None]:
    """Ops (and collectives) inside this block count ``n`` times: they
    stand for ``n`` passes of equal shape."""
    _SCALE[0] *= n
    try:
        yield
    finally:
        _SCALE[0] /= n


def equal_passes(items: Sequence, like: torch.Tensor) -> Iterator:
    """The items of a loop whose passes are equal in shape. When ``like``
    is a ``meta`` tensor only the first is yielded, and the ops and
    collectives of its pass count ``len(items)`` times (a backward of the
    pass's ops counts so only if it runs in the pass, as the mesh train
    step's does)."""
    if like.is_meta and len(items) > 1:
        with repeated(len(items)):
            yield items[0]
    else:
        yield from items


class _EqualCalls(torch.autograd.Function):
    """``fn(*xs)`` run once for ``n`` calls of equal shape on ``meta``
    tensors: its forward ops, and the backward ops autograd runs through
    it later, count ``n`` times."""

    @staticmethod
    def forward(ctx, n, fn, *xs):
        ins = [x.detach().requires_grad_(x.requires_grad) for x in xs]
        # the inner graph keeps its own saved tensors (meta: no storage),
        # whatever hooks an enclosing checkpoint has set
        with torch.enable_grad(), repeated(n), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                         lambda t: t):
            outs = fn(*ins)
        ctx.n, ctx.ins, ctx.outs = n, ins, outs
        ctx.mark_non_differentiable(*(o for o in outs
                                      if not o.requires_grad))
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        need = [i for i, x in enumerate(ctx.ins) if x.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, gs)
                 if o.requires_grad and g is not None]
        res = [None] * len(ctx.ins)
        if need and pairs:
            with repeated(ctx.n):
                got = torch.autograd.grad([o for o, _ in pairs],
                                          [ctx.ins[i] for i in need],
                                          [g for _, g in pairs],
                                          allow_unused=True)
            for i, g in zip(need, got):
                res[i] = g
        return (None, None, *res)


def equal_calls(fn: Callable, items: Sequence,
                args_of: Callable[[object], tuple]) -> list:
    """``[fn(item, *args_of(item)) for item in items]``, the calls equal in
    shape and ``fn`` returning a tuple of tensors. On ``meta`` tensors the
    first call runs alone and its result stands for every item: its
    forward ops, and the backward ops autograd runs through it, count
    ``len(items)`` times."""
    first = args_of(items[0])
    if first[0].is_meta and len(items) > 1:
        outs = _EqualCalls.apply(len(items),
                                 lambda *xs: fn(items[0], *xs), *first)
        return [outs] * len(items)
    return [fn(items[0], *first)] + [fn(it, *args_of(it))
                                     for it in items[1:]]


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Ops inside this block are not counted (the data movement that
    carries out a recorded collective)."""
    _SUSPENDED[0] += 1
    try:
        yield
    finally:
        _SUSPENDED[0] -= 1


def record_collective(kind: str, nbytes: float, count: int = 1) -> None:
    """Add a collective of ``kind`` whose output is ``nbytes`` to every
    active counter."""
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    count = count * _SCALE[0]
    for c in _ACTIVE:
        c.collectives[kind]["bytes"] += float(nbytes) * count
        c.collectives[kind]["count"] += count


def _flat(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    return []


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _numel(ts) -> float:
    return float(sum(t.numel() for t in ts))


def _dot_flops(name: str, args, outs) -> float:
    if not outs:
        return 0.0
    out = float(outs[0].numel())
    if name in ("mm", "bmm", "mv"):
        return 2.0 * out * args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        return 2.0 * out * args[1].shape[-1]
    if name == "dot" or name == "vdot":
        return 2.0 * args[0].numel()
    if name in ("convolution", "_convolution", "conv1d", "conv2d"):
        w = args[1]
        return 2.0 * out * (w.numel() // w.shape[0])
    if name.startswith("_scaled_dot_product"):
        q, k = args[0], args[1]                 # [B, H, Sq, D], [B, H, Sk, D]
        return 2.0 * 2.0 * q.numel() * k.shape[-2]
    return 0.0


_DOTS = {"mm", "bmm", "mv", "addmm", "baddbmm", "addbmm", "addmv", "dot",
         "vdot", "convolution", "_convolution", "conv1d", "conv2d"}


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes and collectives of the ops run inside it:
    ``flops`` (dot + elementwise), ``dot_flops``, ``bytes``,
    ``collectives`` (kind -> {"bytes", "count"}) and ``ops`` (aten op name
    -> calls)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {
            k: {"bytes": 0.0, "count": 0} for k in COLLECTIVES}
        self.ops: Counter = Counter()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _SUSPENDED[0]:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.endswith("__"):   # in place
            name = name[:-1]
        n = _SCALE[0]
        self.ops[name] += n
        if name in _NO_DATA:
            return
        outs = _flat(out)
        ins = _flat(args) + _flat(kwargs)
        self.bytes += n * (_nbytes(ins) + _nbytes(outs))
        if name in _DOTS or name.startswith("_scaled_dot_product"):
            f = _dot_flops(name, args, outs)
            self.dot_flops += n * f
            self.flops += n * f
            if name in ("addmm", "baddbmm", "addbmm", "addmv"):
                self.flops += n * _numel(outs[:1])   # the bias add
        elif name in _ELEMENTWISE:
            self.flops += n * _numel(outs[:1])

    def collective_bytes(self) -> float:
        """Sum of collective output bytes, all-reduce counted twice (the
        reference's ring model)."""
        return sum((2.0 if k == "all-reduce" else 1.0) * v["bytes"]
                   for k, v in self.collectives.items())

    def summary(self) -> Dict[str, object]:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "bytes": self.bytes,
                "collective_bytes": self.collective_bytes(),
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items() if v["count"]}}


def analyze(fn, *args, **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`; returns
    its summary (the counterpart of ``hlo_parse.analyze``)."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.summary()


__all__ = ["OpCounter", "analyze", "record_collective", "uncounted",
           "repeated", "equal_passes", "equal_calls", "COLLECTIVES"]
