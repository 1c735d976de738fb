"""repro_torch.launch — the device mesh helpers and the ``serve`` entry
point (``--mode lm | spmv | fleet``)."""
from .mesh import dp_axes, make_mesh, model_axis

__all__ = ["make_mesh", "dp_axes", "model_axis"]
