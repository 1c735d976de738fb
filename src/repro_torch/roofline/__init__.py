"""repro_torch.roofline — the SpMM traffic model with H100 constants."""
from . import analysis
from .analysis import (HBM_BW, NVLINK_BW, PEAK_FLOPS_FP32,
                       csr_stream_bytes, device_properties, ridge_intensity,
                       spmm_arithmetic_intensity,
                       spmm_distributed_collective_s,
                       spmm_distributed_gather_s, spmm_distributed_time,
                       spmm_distributed_traffic, spmm_touched_fraction)

__all__ = ["analysis", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS_FP32",
           "csr_stream_bytes", "device_properties", "ridge_intensity", "spmm_arithmetic_intensity",
           "spmm_distributed_traffic", "spmm_distributed_time",
           "spmm_distributed_collective_s", "spmm_distributed_gather_s",
           "spmm_touched_fraction"]
