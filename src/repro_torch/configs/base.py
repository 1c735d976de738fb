"""Config registry: assigned architectures x input shapes (the port of
``repro.configs.base``).

Each architecture lives in its own module (``repro_torch/configs/<id>.py``,
dashes/dots -> underscores) exporting ``CONFIG`` (the published config)
and ``REDUCED`` (CPU test scale). The modules are data: the same numbers
as the reference's, with torch dtypes where it has jnp dtypes. SHAPES are
the assigned input shapes; ``long_500k`` only applies to sub-quadratic
archs."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "starcoder2-7b", "qwen2.5-3b", "qwen3-4b", "llama3.2-1b", "mamba2-1.3b",
    "granite-moe-1b-a400m", "mixtral-8x22b", "musicgen-large",
    "jamba-1.5-large-398b", "internvl2-2b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.REDUCED if reduced else mod.CONFIG


def registry(reduced: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}


def long_context_capable(cfg: ModelConfig) -> bool:
    """True unless the stack is *pure* full attention: SSM/hybrid stacks
    and sliding-window stacks run long_500k; pure full-attention archs
    skip it."""
    pure_full_attn = all(m == "attn" for m in cfg.block_pattern) \
        and cfg.sliding_window == 0
    return not pure_full_attn


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped cells flagged."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            skip = s.name == "long_500k" and not long_context_capable(cfg)
            if include_skipped or not skip:
                out.append((a, s.name, skip))
    return out
