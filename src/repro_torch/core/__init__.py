"""repro_torch.core — storage formats, their conversions, space-filling
curves, merge-path partitioning, the ``spmv`` dispatch, the §7
algorithm selector and the §8 autotuner."""
from .formats import (BICRS, COO, CSR, ICRS, BlockedSparse,
                      BLOCK_STORAGE_BICRS, BLOCK_STORAGE_CSR,
                      BLOCK_STORAGE_DENSE_PTR, IN_BLOCK_ICRS,
                      IN_BLOCK_PACKED_COO)
from .device import resolve_device
from .convert import (ALGORITHM_SPECS, AlgorithmSpec, block_size_for,
                      coo_canonicalize_np, coo_to_bicrs, coo_to_blocked,
                      coo_to_csr, coo_to_icrs, convert, to_coo)
from .curves import (curve_key, hilbert_decode, hilbert_key, hilbert_key_np,
                     morton_decode, morton_key)
from .mergepath import (MergePartition, balanced_row_bands,
                        merge_path_partition, merge_path_partition_np,
                        span_block_aligned)
from .selector import (CHUNK_CANDIDATES, GATHER_CANDIDATES, SCHEDULES,
                       DistributedChoice, MachineSpec, MatrixStats, PlanSpec,
                       amortized_cost, break_even_spmvs, matrix_stats,
                       mesh_factorizations, select, select_algorithm,
                       select_distributed, spmm_cost_scale)
from .autotune import TuneResult, autotune
from .spmv import (spmv, spmv_blocked, spmv_coo, spmv_csr, spmv_dense_oracle,
                   spmv_incremental)

__all__ = [
    "COO", "CSR", "ICRS", "BICRS", "BlockedSparse", "resolve_device",
    "BLOCK_STORAGE_BICRS", "BLOCK_STORAGE_CSR", "BLOCK_STORAGE_DENSE_PTR",
    "IN_BLOCK_ICRS", "IN_BLOCK_PACKED_COO",
    "ALGORITHM_SPECS", "AlgorithmSpec", "block_size_for",
    "coo_canonicalize_np", "coo_to_csr", "coo_to_icrs", "coo_to_bicrs",
    "coo_to_blocked", "convert", "to_coo",
    "curve_key", "hilbert_key", "hilbert_decode", "morton_key",
    "morton_decode", "hilbert_key_np", "MergePartition",
    "balanced_row_bands", "merge_path_partition", "merge_path_partition_np",
    "span_block_aligned", "autotune", "TuneResult",
    "CHUNK_CANDIDATES", "GATHER_CANDIDATES", "SCHEDULES",
    "DistributedChoice", "MachineSpec", "MatrixStats", "PlanSpec",
    "amortized_cost", "break_even_spmvs", "matrix_stats",
    "mesh_factorizations", "select", "select_algorithm",
    "select_distributed", "spmm_cost_scale",
    "spmv", "spmv_coo", "spmv_csr", "spmv_incremental", "spmv_blocked",
    "spmv_dense_oracle",
]
