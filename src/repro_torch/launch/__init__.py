"""repro_torch.launch — the device mesh helpers (the production meshes
and the ambient mesh), the sharding rules (``shardings``), the step
builders and per-cell lowering (``steps``), the dry run (``dryrun``), and
the ``serve`` (``--mode lm | spmv | fleet``) and ``train`` entry points."""
from .mesh import (current_mesh, dp_axes, make_mesh, make_production_mesh,
                   model_axis, set_mesh)

__all__ = ["make_production_mesh", "make_mesh", "dp_axes", "model_axis",
           "set_mesh", "current_mesh"]
