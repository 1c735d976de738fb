"""repro_torch.kernels — the merge-path SpMV kernel (K4), the carry step,
and the build/binding of the CUDA sources in ``repro_torch/csrc``."""
from . import ops
from .merge_spmv import MergePlan, cached_merge_plan, merge_plan

__all__ = ["ops", "MergePlan", "merge_plan", "cached_merge_plan"]
