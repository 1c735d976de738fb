"""repro_torch.core — storage formats, the flat conversions, merge-path
partitioning, the ``spmv`` dispatch and the §7 algorithm selector."""
from .formats import COO, CSR
from .device import resolve_device
from .convert import (ALGORITHM_SPECS, AlgorithmSpec, coo_canonicalize_np,
                      coo_to_csr, convert, to_coo)
from .mergepath import merge_path_partition_np
from .selector import (CHUNK_CANDIDATES, GATHER_CANDIDATES, SCHEDULES,
                       DistributedChoice, MachineSpec, MatrixStats, PlanSpec,
                       amortized_cost, break_even_spmvs, matrix_stats,
                       mesh_factorizations, select, select_algorithm,
                       select_distributed, spmm_cost_scale)
from .spmv import spmv, spmv_coo, spmv_csr

__all__ = [
    "COO", "CSR", "resolve_device", "ALGORITHM_SPECS", "AlgorithmSpec",
    "coo_canonicalize_np", "coo_to_csr", "convert", "to_coo",
    "merge_path_partition_np",
    "CHUNK_CANDIDATES", "GATHER_CANDIDATES", "SCHEDULES",
    "DistributedChoice", "MachineSpec", "MatrixStats", "PlanSpec",
    "amortized_cost", "break_even_spmvs", "matrix_stats",
    "mesh_factorizations", "select", "select_algorithm",
    "select_distributed", "spmm_cost_scale",
    "spmv", "spmv_coo", "spmv_csr",
]
