"""repro_torch.runtime — the train loop's supervisor (checkpointed crash
recovery), straggler monitoring, and elastic scaling: the shrink policy
behind the fleet's device-loss re-deal (``repro_torch.spmm.fleet``),
``build_mesh`` and ``reshard`` (a tree re-placed on a mesh).
"""
from .elastic import build_mesh, largest_feasible_mesh, reshard
from .fault_tolerance import StragglerMonitor, Supervisor

__all__ = ["Supervisor", "StragglerMonitor", "build_mesh",
           "largest_feasible_mesh", "reshard"]
