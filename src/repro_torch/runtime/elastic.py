"""Elastic scaling (the port of ``repro.runtime.elastic``): rebuild the
mesh from the live device set and re-place every tensor on it.

When devices are lost, the model axis keeps its width (it matches how the
columns or the model are split) and the data axis absorbs the loss
(:func:`largest_feasible_mesh`; ``SparseOperator.shrink_to`` applies it
to a mesh plan's survivors). Because the LM's sharding is rule-based
(``launch.shardings`` maps parameter paths to specs independent of the
mesh size), re-placing a tree is one :func:`reshard`: no reshape of the
math, only of the layout.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import (NamedSharding, PartitionSpec,
                                          ShardedTensor)


def build_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
               devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``axis_sizes`` over the first devices of ``devices``
    (default: the machine's CUDA cards); a list may repeat a device."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    need = int(np.prod(axis_sizes))
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = d
    return Mesh(arr.reshape(tuple(axis_sizes)), tuple(axis_names))


def largest_feasible_mesh(num_devices: int, model_parallel: int,
                          axis_names: Tuple[str, str] = ("data", "model")
                          ) -> Tuple[int, int]:
    """``(data, model)`` for ``num_devices`` survivors: the model axis
    stays ``model_parallel`` wide, the data axis takes what divides."""
    data = num_devices // model_parallel
    if data < 1:
        raise ValueError("fewer devices than one model replica")
    return (data, model_parallel)


def _map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the tensors (and placed tensors) of a
    nesting of dicts, lists, tuples and named tuples; a module maps to a
    dict of its parameters by name."""
    if isinstance(tree, (torch.Tensor, ShardedTensor)):
        return fn(path, tree)
    if isinstance(tree, nn.Module):
        return {n: fn(path + (n,), p) for n, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_tree(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"cannot reshard a {type(tree).__name__} at "
                    f"{'/'.join(path) or '<root>'}")


def reshard(tree: Any, mesh: Mesh,
            spec_fn: Callable[[str, Any], PartitionSpec]) -> Any:
    """Re-place every leaf under ``mesh`` with rule-derived specs: each
    becomes a :class:`ShardedTensor` (one block per position, on the
    position's device, equal copies along the axes the spec leaves out;
    ``.gather()`` gives the leaf back whole). A leaf already placed on
    another mesh is gathered first. A spec naming an axis the target mesh
    does not carry (a rule written for the pre-shrink mesh) is rejected up
    front."""
    def one(path, leaf):
        key = "/".join(path)
        spec = spec_fn(key, leaf)
        for entry in spec:
            names = entry if isinstance(entry, tuple) else (entry,)
            for name in names:
                if name is not None and name not in mesh.axis_names:
                    raise ValueError(
                        f"spec for {key!r} names axis {name!r}, but the "
                        f"target mesh only has {tuple(mesh.axis_names)}")
        if isinstance(leaf, ShardedTensor):
            leaf = leaf.gather()
        return ShardedTensor.place(leaf, NamedSharding(mesh, spec))
    return _map_tree(one, tree)


__all__ = ["build_mesh", "largest_feasible_mesh", "reshard"]
