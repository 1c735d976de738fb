"""repro_torch.checkpoint — atomic checkpointing (the port of
``repro.checkpoint``)."""
from . import checkpoint
from .checkpoint import latest_step, restore, restore_meta, save

__all__ = ["checkpoint", "save", "restore", "restore_meta", "latest_step"]
