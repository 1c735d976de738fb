"""Sharding rules (the port of ``repro.launch.shardings``): parameter path
-> PartitionSpec (2D TP x FSDP), batch and cache specs per input shape,
and the placed tensors that carry a sharding on the port's single-
controller mesh.

Conventions (single pod; the multi-pod "pod" axis is pure DP and only
carries the batch), as in the reference:
  * weights are 2D-sharded: the TP dimension (heads / ffn / experts /
    vocab) over "model", the other matrix dimension over "data" (FSDP);
  * any dimension not divisible by its axis size falls back to
    replication on that axis (guarded here, so every arch has a spec);
  * decode KV caches shard batch over DP and sequence over "model"; for
    long_500k (batch=1) the sequence is sharded over EVERY axis.

The rules match the reference's key paths (``groups/0/mixer/wq/w``). The
port holds one tensor per layer (``ParamTree``); its leaves are mapped
through ``ParamTree.leaf_stacks()``: a stacked leaf is the reference's
``groups/<slot>/...`` leaf (``grouped=True``, shape ``[n_groups, ...]``),
and each layer's tensor takes the stacked spec without its leading
``None`` (:func:`param_shardings`).

:class:`PartitionSpec` (``P``) and :class:`NamedSharding` are the port's
own, with JAX's meaning: a spec entry names the mesh axis (or tuple of
axes) a dimension is split over, ``None`` keeps it whole, and the axes a
spec leaves out replicate. :class:`ShardedTensor` is a tensor placed that
way: one local tensor per mesh position, on the position's device
(``runtime.elastic.reshard`` makes them).
"""
from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, dp_axes


class PartitionSpec(tuple):
    """A tuple of per-dimension entries: an axis name, a tuple of axis
    names, or None. A one-name tuple is stored as the name, as JAX
    stores it."""

    def __new__(cls, *entries):
        norm = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                     (tuple(e) if isinstance(e, (tuple, list)) else e)
                     for e in entries)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return "PartitionSpec" + (tuple.__repr__(self) if len(self) != 1
                                  else f"({self[0]!r})")


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def path_str(path) -> str:
    """Normalize a key path (keys, indices, or objects with ``key``/
    ``idx``/``name``) to 'a/b/0/c' (rules match on this form)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _axis_size(mesh: Mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _guard(spec: Tuple, shape: Tuple[int, ...], mesh: Mesh) -> P:
    """Drop axes that don't divide their dimension."""
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
        elif dim % _axis_size(mesh, ax) == 0:
            fixed.append(ax)
        else:
            fixed.append(None)
    return P(*fixed)


# rules: regex on the key path; entries are spec TEMPLATES where the
# leading group-stack dimension is added automatically for group params.
_PARAM_RULES = [
    (r"embed", ("model", "data")),
    (r"unembed/w$", ("data", "model")),
    (r"vision_proj/w$", (None, "model")),
    (r"(wq|wk|wv)/w$", ("data", "model")),
    (r"(wq|wk|wv)/b$", ("model",)),
    (r"wo/w$", ("model", "data")),
    (r"wo/b$", (None,)),
    # MoE experts [E, d, f] / [E, f, d]: expert-parallel over "model" when
    # E divides, else ffn-parallel (_moe_fallback)
    (r"mlp/w_gate$", ("model", "data", None)),
    (r"mlp/w_up$", ("model", "data", None)),
    (r"mlp/w_down$", ("model", None, "data")),
    (r"router/w$", ("data", None)),
    # dense MLP
    (r"mlp/(w_gate|w_up|w_in)/w$", ("data", "model")),
    (r"mlp/(w_in|w_gate|w_up)/b$", ("model",)),
    (r"mlp/(w_down|w_out)/w$", ("model", "data")),
    (r"mlp/(w_down|w_out)/b$", (None,)),
    # SSM
    (r"in_proj/w$", ("data", "model")),
    (r"out_proj/w$", ("model", "data")),
    (r"conv/w$", (None, "model")),
    (r"conv/b$", ("model",)),
    (r"(A_log|D|dt_bias|norm_scale)$", ("model",)),
]


def _moe_fallback(template, shape, mesh):
    """If experts don't divide "model", switch to ffn-parallel."""
    if len(shape) == 3 and shape[0] % _axis_size(mesh, "model") != 0:
        if template == ("model", "data", None):       # w_gate/w_up [E,d,f]
            return (None, "data", "model")
        if template == ("model", None, "data"):       # w_down [E,f,d]
            return (None, "model", "data")
    return template


def param_spec_for(key: str, leaf_shape: Tuple[int, ...], mesh: Mesh,
                   grouped: bool, profile: str = "tp") -> P:
    core_shape = leaf_shape[1:] if grouped else leaf_shape
    if profile == "fsdp":
        # FSDP-only: every >=2D weight shards its largest dimension over
        # the WHOLE mesh (ZeRO-3); activations are fully batch-parallel
        if len(core_shape) >= 2:
            all_axes = tuple(mesh.axis_names)
            dim = int(max(range(len(core_shape)),
                          key=lambda i: core_shape[i]))
            spec = [None] * len(core_shape)
            if core_shape[dim] % _axis_size(mesh, all_axes) == 0:
                spec[dim] = all_axes
            elif core_shape[dim] % _axis_size(mesh, "model") == 0:
                spec[dim] = "model"
            out = P(*spec)
            return P(*((None,) + tuple(out))) if grouped else out
        return P(*((None,) * len(leaf_shape)))
    for pat, template in _PARAM_RULES:
        if re.search(pat, key):
            if len(template) != len(core_shape):
                continue
            if "mlp" in key and len(core_shape) == 3:
                template = _moe_fallback(template, core_shape, mesh)
            spec = _guard(template, core_shape, mesh)
            return P(*((None,) + tuple(spec))) if grouped else spec
    # norms, scalars, anything unmatched: replicate
    return P(*((None,) * len(leaf_shape)))


class NamedSharding:
    """``spec`` laid over ``mesh``: where each position's block of an
    array of a given shape lies."""

    def __init__(self, mesh: Mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        for entry in self.spec:
            for name in _entry_axes(entry):
                if name not in mesh.axis_names:
                    raise ValueError(f"spec {self.spec} names axis {name!r},"
                                     f" the mesh has {mesh.axis_names}")

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={_mesh_shape(self.mesh)}, " \
               f"spec={self.spec!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and \
            self.mesh is other.mesh and self.spec == other.spec

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def _entries(self, ndim: int):
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"array's {ndim} dimensions")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one position's block of a ``shape`` array."""
        out = []
        for dim, entry in zip(shape, self._entries(len(shape))):
            n = _axis_size(self.mesh, entry) if entry is not None else 1
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(shape)} is not "
                                 f"divisible by {n} (spec {self.spec})")
            out.append(dim // n)
        return tuple(out)

    def index(self, pos: Tuple[int, ...], shape: Sequence[int]
              ) -> Tuple[slice, ...]:
        """The block of a ``shape`` array that mesh position ``pos``
        (one coordinate per mesh axis) holds."""
        coord = dict(zip(self.mesh.axis_names, pos))
        block = self.shard_shape(shape)
        out = []
        for size, entry in zip(block, self._entries(len(shape))):
            i = 0
            for name in _entry_axes(entry):          # row-major over axes
                i = i * _axis_size(self.mesh, name) + coord[name]
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)


def positions(mesh: Mesh) -> List[Tuple[int, ...]]:
    """Every mesh position, row-major."""
    return list(itertools.product(*(range(s) for s in mesh.devices.shape)))


class ShardedTensor:
    """A tensor of ``shape`` placed by ``sharding``: ``shards[pos]`` is
    position ``pos``'s block, on ``mesh.devices[pos]``. Positions that
    differ only along axes the spec leaves out hold equal copies."""

    def __init__(self, shards: Dict[Tuple[int, ...], torch.Tensor],
                 sharding: NamedSharding, shape: Sequence[int]):
        self.shards = shards
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @classmethod
    def place(cls, tensor: torch.Tensor, sharding: NamedSharding
              ) -> "ShardedTensor":
        """One block of ``tensor`` per position, copied to its device."""
        mesh = sharding.mesh
        shards = {}
        meta = None
        for pos in positions(mesh):
            dev = torch.device(mesh.devices[pos])
            if dev.type == "meta":
                # no storage to copy: every position holds one meta block
                if meta is None:
                    meta = torch.empty(sharding.shard_shape(tensor.shape),
                                       dtype=tensor.dtype, device="meta")
                shards[pos] = meta
                continue
            block = tensor.detach()[sharding.index(pos, tensor.shape)]
            shards[pos] = block.to(dev, copy=True)
        return cls(shards, sharding, tensor.shape)

    def distinct(self) -> List[Tuple[int, ...]]:
        """One position for each distinct block: the first along every
        axis the spec leaves out."""
        used = {n for e in self.sharding.spec for n in _entry_axes(e)}
        return [pos for pos in positions(self.mesh)
                if all(c == 0 for name, c in zip(self.mesh.axis_names, pos)
                       if name not in used)]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: position 0's)."""
        first = next(iter(self.shards.values()))
        dev = torch.device(device) if device is not None else first.device
        out = torch.empty(self.shape, dtype=first.dtype, device=dev)
        if dev.type == "meta":
            return out
        for pos in self.distinct():
            out[self.sharding.index(pos, self.shape)] = \
                self.shards[pos].to(dev)
        return out

    def shard_bytes(self) -> int:
        """Bytes of one position's block."""
        n = int(np.prod(self.sharding.shard_shape(self.shape)))
        return n * torch.empty((), dtype=self.dtype).element_size()

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"{self.sharding!r})")


# ---------------------------------------------------------------------------
# the port's parameter and state trees
# ---------------------------------------------------------------------------
def reference_key(name: str, stacked: bool) -> str:
    """The reference's key path of a ``leaf_stacks`` entry: a stacked
    ``layers.<slot>.a.b`` is ``groups/<slot>/a/b``; others keep their
    names with '/' for '.'."""
    parts = name.split(".")
    if stacked:
        parts[0] = "groups"
    return "/".join(parts)


def _stacks(params) -> List[Tuple[str, List[torch.Tensor], bool]]:
    from repro_torch.optim.adamw import leaf_stacks
    return leaf_stacks(params)


def _stacked_shape(ts: List[torch.Tensor], stacked: bool) -> Tuple[int, ...]:
    return ((len(ts),) if stacked else ()) + tuple(ts[0].shape)


def _per_tensor(spec: P, stacked: bool) -> P:
    """A layer tensor's spec: the stacked spec without its leading entry
    (the group dimension, never split)."""
    if not stacked:
        return spec
    if spec and spec[0] is not None:
        raise ValueError(f"spec {spec} splits the group dimension")
    return P(*tuple(spec)[1:])


def stacked_specs(params, mesh: Mesh, profile: str = "tp"
                  ) -> Dict[str, P]:
    """``param_spec_for`` of every ``leaf_stacks`` entry, keyed by the
    reference's key path (a stacked leaf at its ``[n_groups, ...]``
    shape)."""
    return {reference_key(n, st): param_spec_for(
        reference_key(n, st), _stacked_shape(ts, st), mesh, st, profile)
        for n, ts, st in _stacks(params)}


def param_shardings(params, mesh: Mesh, profile: str = "tp"
                    ) -> List[NamedSharding]:
    """One ``NamedSharding`` per tensor of ``leaves(params)`` (the order
    gradients and AdamW moments follow): a layer tensor takes its stacked
    leaf's spec without the leading ``None``."""
    out = []
    for n, ts, st in _stacks(params):
        key = reference_key(n, st)
        spec = param_spec_for(key, _stacked_shape(ts, st), mesh, st,
                              profile)
        out += [NamedSharding(mesh, _per_tensor(spec, st))] * len(ts)
    return out


def _reference_order(stacks) -> list:
    """``leaf_stacks`` entries in the reference's tree order (JAX visits
    dict keys sorted and list entries by index)."""
    def key(entry):
        return tuple(int(p) if p.isdigit() else p
                     for p in reference_key(entry[0], entry[2]).split("/"))
    return sorted(stacks, key=key)


def opt_state_shardings(opt_state, params, mesh: Mesh,
                        profile: str = "tp"):
    """Optimizer state mirrors the param shardings; scalars replicate.
    Matching is by shape, as in the reference: a state leaf of a stacked
    shape some parameter leaf has takes that leaf's spec (the last such
    leaf in the reference's tree order), any other leaf replicates.
    AdamW's ``m``/``v`` hold one tensor per layer, each the spec of its
    stacked shape without the leading entry; Adafactor's factors are
    stacked as the reference's. Returns the state's type with a
    ``NamedSharding`` per tensor."""
    stacks = _stacks(params)
    by_shape: Dict[Tuple[int, ...], P] = {}
    for n, ts, st in _reference_order(stacks):
        shape = _stacked_shape(ts, st)
        by_shape[shape] = param_spec_for(reference_key(n, st), shape, mesh,
                                         st, profile)

    def of_shape(shape) -> NamedSharding:
        spec = by_shape.get(tuple(shape))
        return NamedSharding(mesh, spec if spec is not None
                             else P(*((None,) * len(shape))))

    # per tensor of leaves(params): its stacked leaf's shape and flag
    per_tensor = [(_stacked_shape(ts, st), st) for _, ts, st in stacks
                  for _ in ts]

    def moments(ms):
        out = []
        for (shape, st), m in zip(per_tensor, ms):
            spec = of_shape(shape).spec
            if st:
                spec = P(*tuple(spec)[1:]) if spec[0] is None \
                    else P(*((None,) * m.dim()))
            out.append(NamedSharding(mesh, spec))
        return out

    fields = opt_state._fields
    out = {}
    for f in fields:
        v = getattr(opt_state, f)
        if isinstance(v, torch.Tensor):
            out[f] = of_shape(v.shape)
        elif f in ("m", "v"):
            out[f] = moments(v)
        else:
            out[f] = [of_shape(t.shape) for t in v]
    return type(opt_state)(**out)


def batch_sharding(mesh: Mesh, batch: int) -> NamedSharding:
    dp = dp_axes(mesh)
    if batch % _axis_size(mesh, tuple(dp)) != 0:
        return NamedSharding(mesh, P())            # e.g. long_500k B=1
    return NamedSharding(mesh, P(dp, None))


def cache_shardings(cache_shape: Any, mesh: Mesh, batch: int) -> Any:
    """KV caches [G,B,S,Hkv,D] / SSM states [G,B,...]: batch over DP when
    it divides, else the sequence dimension over everything. Returns the
    caches' structure (a list of ``KVCache``/``SSMCache`` per slot) with a
    ``NamedSharding`` per tensor."""
    dp = dp_axes(mesh)
    dp_size = _axis_size(mesh, tuple(dp))
    batch_sharded = batch % dp_size == 0

    def one(leaf):
        shape = leaf.shape
        spec: list = [None] * len(shape)
        if len(shape) >= 2:
            if batch_sharded:
                spec[1] = dp                                 # B over DP
                if len(shape) == 5 and shape[2] % _axis_size(
                        mesh, "model") == 0:
                    spec[2] = "model"                        # KV seq
                elif len(shape) == 5 and shape[2] % _axis_size(
                        mesh, "model") != 0:
                    # ssm_state [G,B,H,P,N]: heads over model (the
                    # reference's branch: its test repeats the one above,
                    # so it never assigns; kept so the specs stay equal)
                    if shape[2] % _axis_size(mesh, "model") == 0:
                        spec[2] = "model"
                elif len(shape) == 4 and shape[3] % _axis_size(
                        mesh, "model") == 0:
                    spec[3] = "model"                        # conv channels
            else:
                # B=1 (long_500k): shard the long axis over every axis
                all_axes = tuple(mesh.axis_names)
                long_dim = max(range(len(shape)), key=lambda i: shape[i])
                if shape[long_dim] % _axis_size(mesh, all_axes) == 0:
                    spec[long_dim] = all_axes
                elif shape[long_dim] % _axis_size(mesh, "model") == 0:
                    spec[long_dim] = "model"
        return NamedSharding(mesh, P(*spec))

    return [type(c)(*(one(t) for t in c)) for c in cache_shape]


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a state, cache or parameter tree in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "leaf_stacks"):
        from repro_torch.optim.adamw import leaves
        return leaves(tree)
    if isinstance(tree, dict):
        tree = list(tree.values())
    out = []
    for v in tree:
        out += _tensors(v)
    return out


def _shardings(tree) -> List[NamedSharding]:
    if isinstance(tree, NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    out = []
    for v in tree:
        out += _shardings(v)
    return out


def with_shardings(shape_tree: Any, sharding_tree: Any) -> Any:
    """Attach shardings to the tensors of a tree (as ``t.sharding``;
    the tree's tensors and ``sharding_tree``'s shardings in the same
    order); returns the tree."""
    ts, shs = _tensors(shape_tree), _shardings(sharding_tree)
    if len(ts) != len(shs):
        raise ValueError(f"{len(ts)} tensors, {len(shs)} shardings")
    for t, sh in zip(ts, shs):
        sh.shard_shape(t.shape)           # raises where it cannot divide
        t.sharding = sh
    return shape_tree


def shard_bytes(tree: Any) -> int:
    """Per-device bytes of a tree whose tensors carry shardings (a tensor
    without one counts whole)."""
    total = 0
    for t in _tensors(tree):
        sh = getattr(t, "sharding", None)
        shape = sh.shard_shape(t.shape) if sh is not None else t.shape
        total += int(np.prod(shape, dtype=np.int64)) * t.element_size()
    return total


__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardedTensor",
           "path_str", "param_spec_for", "param_shardings", "stacked_specs",
           "opt_state_shardings", "batch_sharding", "cache_shardings",
           "with_shardings", "shard_bytes", "positions", "reference_key"]
