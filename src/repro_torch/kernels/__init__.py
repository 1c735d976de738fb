"""repro_torch.kernels — the merge-path SpMV kernel (K4), the carry step,
the tiled blocked-format kernels (K5, K7) with their ``TiledSparse``
format, and the build/binding of the CUDA sources in
``repro_torch/csrc``."""
from . import ops, ref
from .merge_spmv import MergePlan, cached_merge_plan, merge_plan
from .tiling import TILE_C, TILE_R, TiledSparse, coo_to_tiled

__all__ = ["ops", "ref", "MergePlan", "merge_plan", "cached_merge_plan",
           "TILE_R", "TILE_C", "TiledSparse", "coo_to_tiled"]
