"""Checkpointing with atomic commit, async flush and retention (the port
of ``repro.checkpoint.checkpoint``), in the reference's layout:

    <dir>/step_<N>/
        manifest.json          (step, leaf keys and dtypes, meta)
        shard_<host>.npz       (the flattened leaves owned by this host)
    <dir>/step_<N>.COMMITTED   (rename-commit marker)

Restart safety: a checkpoint is visible to ``latest_step`` only after its
COMMITTED marker exists; the marker is written with ``os.replace``
(atomic on POSIX), so a crash mid-save never yields a half checkpoint.
With the step-keyed data pipeline, restore -> replay is bit-exact on the
CPU.

``save`` copies every leaf to host memory before it returns, so the
caller may update its tensors in place (the port's optimizers do) while
the flush thread writes. A tree is any nesting of dicts, lists, tuples,
named tuples and modules (their parameters) over tensors; bfloat16 leaves
are stored as their 16-bit patterns.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf "
                        f"at {prefix or '<root>'}")
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory and its dtype's name."""
    t = leaf.detach().to("cpu", copy=True)
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def save(ckpt_dir: str, step: int, tree: Any, *, host: int = 0,
         meta: Optional[Dict] = None, blocking: bool = True,
         keep: int = 3) -> threading.Thread:
    """Save ``tree`` for ``step``; returns the flush thread (joined when
    ``blocking``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    leaves = _flatten_with_paths(tree)
    # pull to host memory synchronously, flush async
    host_leaves = [_to_host(leaf) for _, leaf in leaves]
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(host_leaves)}
    manifest = {
        "step": step,
        "keys": [k for k, _ in leaves],
        "dtypes": [d for _, d in host_leaves],
        "meta": meta or {},
        "num_hosts": 1,
    }

    def flush():
        os.makedirs(tmp_dir, exist_ok=True)
        np.savez(os.path.join(tmp_dir, f"shard_{host:05d}.npz"), **arrays)
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.replace(tmp_dir, step_dir)
        # commit marker (atomic)
        marker_tmp = step_dir + ".marker"
        with open(marker_tmp, "w") as f:
            f.write(str(step))
        os.replace(marker_tmp, step_dir + ".COMMITTED")
        _apply_retention(ckpt_dir, keep)

    t = threading.Thread(target=flush)
    t.start()
    if blocking:
        t.join()
    return t


def _committed_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.endswith(".COMMITTED"):
            steps.append(int(name[len("step_"):-len(".COMMITTED")]))
    return sorted(steps)


def _apply_retention(ckpt_dir: str, keep: int):
    steps = _committed_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        sd = os.path.join(ckpt_dir, f"step_{s:08d}")
        shutil.rmtree(sd, ignore_errors=True)
        try:
            os.remove(sd + ".COMMITTED")
        except OSError:
            pass


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target_tree: Any, *,
            host: int = 0) -> Any:
    """Load ``step`` into the tensors of ``target_tree`` in place (each
    cast to its target's dtype, on its target's device) and return the
    tree. Raises ``ValueError`` if the leaf count or a shape differs."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    targets = _flatten_with_paths(target_tree)
    keys = manifest["keys"]
    if len(keys) != len(targets):
        raise ValueError(f"checkpoint has {len(keys)} leaves, target "
                         f"{len(targets)}")
    with np.load(os.path.join(step_dir, f"shard_{host:05d}.npz")) as data:
        for i, ((_, tgt), dtype) in enumerate(zip(targets,
                                                  manifest["dtypes"])):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(tgt.shape):
                raise ValueError(f"leaf {keys[i]}: checkpoint {arr.shape} "
                                 f"vs target {tuple(tgt.shape)}")
            src = torch.from_numpy(arr)
            if dtype == "bfloat16":
                src = src.view(torch.bfloat16)
            with torch.no_grad():
                tgt.copy_(src)
    return target_tree


def restore_meta(ckpt_dir: str, step: int) -> Dict:
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)["meta"]
