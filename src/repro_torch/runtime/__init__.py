"""repro_torch.runtime — straggler monitoring and the elastic shrink
policy behind the fleet's device-loss re-deal (``repro_torch.spmm.fleet``).
"""
from .elastic import largest_feasible_mesh
from .fault_tolerance import StragglerMonitor

__all__ = ["StragglerMonitor", "largest_feasible_mesh"]
