"""repro_torch.configs — assigned architecture configs + shape registry."""
from .base import (ARCH_IDS, SHAPES, ShapeSpec, cells, get_config,
                   long_context_capable, registry)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "cells", "get_config",
           "long_context_capable", "registry"]
