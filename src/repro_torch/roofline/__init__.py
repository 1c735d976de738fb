"""repro_torch.roofline — the SpMM traffic model and the step roofline
with H100 constants, and the op counter behind the dry run
(``op_count``, the counterpart of ``repro.roofline.hlo_parse``)."""
from . import analysis
from .analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32,
                       Roofline, collective_bytes_total, csr_stream_bytes,
                       device_properties, from_compiled,
                       parse_collective_bytes, ridge_intensity,
                       spmm_arithmetic_intensity,
                       spmm_distributed_collective_s,
                       spmm_distributed_gather_s, spmm_distributed_time,
                       spmm_roofline_gflops,
                       spmm_distributed_traffic, spmm_touched_fraction)

__all__ = ["analysis", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS_FP32",
           "PEAK_FLOPS_BF16", "Roofline", "from_compiled",
           "parse_collective_bytes", "collective_bytes_total",
           "csr_stream_bytes", "device_properties", "ridge_intensity",
           "spmm_arithmetic_intensity", "spmm_distributed_traffic",
           "spmm_distributed_time", "spmm_distributed_collective_s",
           "spmm_distributed_gather_s", "spmm_touched_fraction",
           "spmm_roofline_gflops"]
