"""repro_torch.launch — the device mesh helpers, the ``serve`` entry point
(``--mode lm | spmv | fleet``), the ``train`` entry point and the step
builders (``steps``)."""
from .mesh import dp_axes, make_mesh, model_axis

__all__ = ["make_mesh", "dp_axes", "model_axis"]
