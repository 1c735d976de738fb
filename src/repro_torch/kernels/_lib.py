"""Build and bind the hand-written CUDA kernels in ``repro_torch/csrc``.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
build happens at first use, never at import: every source is compiled at
once (one ``nvcc`` process each, started together), into ``build/`` at the
root of the checkout, under a name that hashes the source and the flags, so
an edited source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` as an int; :func:`check` turns a non-zero code into
a ``RuntimeError`` that names the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"

SOURCES = {
    "sellcs": "sellcs_spmm.cu",      # K1, K8 and K3
    "merge": "merge_spmm.cu",        # K2, K4 and the carry step
    "tiled": "tiled_spmm.cu",        # K5, K6 and K7
    "moe": "moe_group_matmul.cu",    # K9 (tiled, decode, wgmma)
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry point -> (library, argtypes); every one returns int
SIGNATURES = {
    "sellcs_slots_launch": ("sellcs", [_P, _P, _P, _P, _P, _P, _I, _P]),
    "sellcs_slots_fused_launch": ("sellcs", [_P, _P, _P, _P, _P, _P, _P, _I,
                                             _P]),
    "sellcs_slots_t_launch": ("sellcs", [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _P]),
    # merge multiplies: plan arrays, x, the one output allocation, P, D,
    # m (and k for K2), stream; the *_partials entries stop before the
    # carry step
    "merge_spmm_partials_launch": ("merge", [_P, _P, _P, _P, _P, _P, _P, _I,
                                             _I, _L, _I, _P]),
    "merge_spmm_launch": ("merge", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                                    _I, _P]),
    "merge_spmv_partials_launch": ("merge", [_P, _P, _P, _P, _P, _P, _P, _I,
                                             _I, _L, _P]),
    "merge_spmv_launch": ("merge", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                                    _P]),
    "merge_carry_fixup_launch": ("merge", [_P, _P, _P, _I, _I, _P]),
    "tiled_spmv_launch": ("tiled", [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P,
                                    _P, _P, _I, _I, _L, _P]),
    "tiled_spmm_launch": ("tiled", [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _P]),
    "moe_group_matmul_launch": ("moe", [_P, _I, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _P]),
    "moe_group_matmul_decode_launch": ("moe", [_P, _I, _P, _P, _P, _P, _P,
                                               _I, _I, _I, _I, _P]),
    "moe_group_matmul_wgmma_launch": ("moe", [_P, _I, _P, _P, _P, _P, _I,
                                              _I, _I, _I, _P]),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source of the last verbose build (``-Xptxas=-v``)
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the checkout root (``src/`` layout); next
    to the package when it is installed elsewhere."""
    pkg = Path(__file__).resolve().parent.parent
    root = pkg.parent.parent
    if (root / "src" / "repro_torch").is_dir():
        return root / "build" / "repro_torch"
    return pkg / "_build"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Dict[str, float]:
    """Compile every source that has no up-to-date library yet, all at
    once. Returns the wall seconds of the whole build per source built
    (empty when everything was cached). Raises with nvcc's output on a
    failed compile."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors: List[str] = []
    secs: Dict[str, float] = {}
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {SOURCES[name]}:\n{log}")
            continue
        if verbose and log:
            BUILD_LOGS[name] = log
            print(log)
        os.replace(tmp, target)
        secs[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _target(name).exists():
                build()
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (owner, argtypes) in SIGNATURES.items():
                if owner == name:
                    f = getattr(lib, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def entry(fn: str):
    """The bound C entry point ``fn``."""
    return getattr(library(SIGNATURES[fn][0]), fn)


def check(rc: int, fn: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library(SIGNATURES[fn][0]).repro_error_string(rc)
        raise RuntimeError(f"{fn}: CUDA error {rc} "
                           f"({msg.decode() if msg else 'unknown'})")


_SM_COUNT: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device`` (a CUDA device), for the kernels
    that launch a persistent grid."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


_L2_BYTES: Dict[int, int] = {}


def l2_bytes(device: torch.device) -> int:
    """The L2 cache size of ``device`` (a CUDA device), in bytes."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _L2_BYTES:
        _L2_BYTES[idx] = \
            torch.cuda.get_device_properties(idx).L2_cache_size
    return _L2_BYTES[idx]


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer int (the
    raw handle, without building a ``torch.cuda.Stream``: a few
    microseconds less per launch, which the single-vector kernels feel)."""
    idx = t.get_device()
    return torch._C._cuda_getCurrentRawStream(
        idx if idx >= 0 else torch.cuda.current_device())


def require(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    """Validate one kernel operand before its pointer is passed to C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
