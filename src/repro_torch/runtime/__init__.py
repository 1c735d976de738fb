"""repro_torch.runtime — the train loop's supervisor (checkpointed crash
recovery), straggler monitoring, and the elastic shrink policy behind the
fleet's device-loss re-deal (``repro_torch.spmm.fleet``).
"""
from .elastic import largest_feasible_mesh
from .fault_tolerance import StragglerMonitor, Supervisor

__all__ = ["Supervisor", "StragglerMonitor", "largest_feasible_mesh"]
