"""Mamba-2 (SSD) layer configuration (from ``repro.models.ssm``).

Only ``SSMConfig`` is here, which the model config and the parameter
accounting read. The SSM mixer itself (``ssm_init``, ``ssm_forward``,
``ssm_decode``) is not ported yet (ROADMAP.md queue 1 item 3); a config
with an ``"ssm"`` slot raises ``NotImplementedError`` in
``repro_torch.models.model``.
"""
from __future__ import annotations

from typing import NamedTuple


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def nheads(self) -> int:
        return self.d_inner // self.headdim
