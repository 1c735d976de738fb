"""The elastic shrink policy — the port of
``repro.runtime.elastic.largest_feasible_mesh``.

When devices are lost, the model axis keeps its width (it matches how the
columns or the model are split) and the data axis absorbs the loss.
``SparseOperator.shrink_to`` applies it to a mesh plan's survivors. The
reference's ``build_mesh`` and ``reshard`` come with the LM mesh slice.
"""
from __future__ import annotations

from typing import Tuple


def largest_feasible_mesh(num_devices: int, model_parallel: int,
                          axis_names: Tuple[str, str] = ("data", "model")
                          ) -> Tuple[int, int]:
    """``(data, model)`` for ``num_devices`` survivors: the model axis
    stays ``model_parallel`` wide, the data axis takes what divides."""
    data = num_devices // model_parallel
    if data < 1:
        raise ValueError("fewer devices than one model replica")
    return (data, model_parallel)


__all__ = ["largest_feasible_mesh"]
