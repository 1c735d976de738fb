"""Device meshes for the multi-device SpMM schedules — the port of
``repro.launch.mesh``.

A :class:`Mesh` is an object array of ``torch.device`` with one name per
axis, shaped like JAX's: ``mesh.shape[axis]`` is the axis length and
``mesh.devices[i, j]`` the device at a position. The multiplies of
``repro_torch.spmm.distributed`` run one controller over it: each shard's
kernels launch on its mesh device, and the sums across shards are taken on
the output device.

An explicit ``devices`` list may name one device more than once
(``[torch.device("cuda:0")] * 4``, ``["cpu"] * 8``): every shard then runs
on that device at shard shapes. This is the port's counterpart of the
reference's ``XLA_FLAGS=--xla_force_host_platform_device_count`` and the
only way to build a mesh larger than the number of cards. ``devices=None``
takes the first cards of the machine and raises when there are too few.

The LM mesh uses the reference's production meshes
(:func:`make_production_mesh`): the dry run lays them over ``meta``
positions (``devices=["meta"] * 256``), which hold shapes and no data.
:func:`set_mesh` makes a mesh ambient (the port's ``repro.compat.set_mesh``):
the expert-parallel MoE dispatch and the model's batch constraint read it.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An n-d grid of devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} need "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _devices(need: int, devices: Optional[Sequence[DeviceLike]]):
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < need:
            raise ValueError(
                f"the mesh needs {need} devices, found {count} CUDA devices;"
                " pass devices= explicitly (a list may repeat a device, e.g."
                " ['cuda:0'] * 4, to run every shard on one card)")
        return [torch.device("cuda", i) for i in range(need)]
    devs = [torch.device(d) for d in devices]
    if len(devs) < need:
        raise ValueError(f"the mesh needs {need} devices, got {len(devs)}")
    return devs[:need]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` of ``devices``
    (default: the machine's CUDA cards), filled in row-major order."""
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be positive, got {shape}")
    need = int(np.prod(shape))
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(_devices(need, devices)):
        grid[i] = d
    return Mesh(grid.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> Mesh:
    """The reference's production mesh: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod``, over ``devices``
    (default: the machine's cards; raises when there are too few)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh) -> Iterator[Mesh]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`set_mesh`, or None."""
    return _AMBIENT.get()


_LOCAL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh_local", default=None)


@contextlib.contextmanager
def at_coords(coords: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Inside the block, the program runs at these coordinates of some
    mesh axes: the batch it sees is already that block of the global
    batch (the mesh train step runs one forward per data position)."""
    token = _LOCAL.set(dict(coords))
    try:
        yield coords
    finally:
        _LOCAL.reset(token)


def local_coords() -> Dict[str, int]:
    """The coordinates of the innermost :func:`at_coords` (empty outside
    one: the program sees the whole batch)."""
    return _LOCAL.get() or {}


def make_spmm_mesh(mesh_shape: Tuple[int, int],
                   devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Mesh for the distributed SpMM schedules from a (P_data, P_model)
    factorization: 1-D ``("data",)`` when the model axis is trivial, 2-D
    ``("data", "model")`` otherwise (the multiplies then split the X/Y
    columns across ``model``)."""
    pd, pm = int(mesh_shape[0]), int(mesh_shape[1])
    if pd < 1 or pm < 1:
        raise ValueError(f"mesh_shape must be positive, got {mesh_shape}")
    if pm == 1:
        return make_mesh((pd,), ("data",), devices=devices)
    return make_mesh((pd, pm), ("data", "model"), devices=devices)


def parse_mesh_shape(spec: str) -> Tuple[int, int]:
    """Parse a ``"Pd,Pm"`` (or ``"PdxPm"``) CLI mesh argument."""
    parts = spec.replace("x", ",").split(",")
    try:
        pd, pm = (int(p) for p in parts)
    except ValueError:
        raise SystemExit(f"--mesh must be Pd,Pm (two ints), got {spec!r}")
    if pd < 1 or pm < 1:
        raise SystemExit(f"--mesh entries must be >= 1, got {spec!r}")
    return pd, pm


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes carrying the batch dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh: Mesh) -> str:
    return "model"
