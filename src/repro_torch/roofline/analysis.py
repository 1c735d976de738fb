"""SpMM roofline and traffic model with NVIDIA H100 constants.

The functions are the reference's (``repro.roofline.analysis``) traffic
model: the streamed matrix bytes, the X read and the Y write of one k-RHS
multiply, plus the exposed collective and gather terms of the distributed
schedules. Only the hardware constants change. They are the H100 SXM data
sheet's (NVIDIA H100 Tensor Core GPU data sheet; dense rates, 700 W):
3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores, 450 GB/s
NVLink each way. What
``torch.cuda.get_device_properties`` reports (name, SM count, memory, L2)
is read by :func:`device_properties`; it reports no bandwidth or peak, so
those stay data-sheet figures.

The SpMM kernels of this package compute in float32 on the CUDA cores, so
the ridge that matters for them is the float32 one (~20 flop/byte).
Parsing compiled HLO (``from_compiled``) belongs to the JAX package and is
not ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet figures (per card)
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
L2_BYTES = 50 * 2 ** 20


def device_properties(device=None) -> Dict[str, object]:
    """What ``torch.cuda.get_device_properties`` reports for ``device``
    (name, SMs, memory, L2), next to the data-sheet rates above. Raises
    when no CUDA device is available."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("device_properties needs a CUDA device")
    p = torch.cuda.get_device_properties(device or 0)
    return {"name": p.name, "sm_count": p.multi_processor_count,
            "total_memory": p.total_memory,
            "l2_bytes": getattr(p, "L2_cache_size", L2_BYTES),
            "hbm_bw": HBM_BW, "peak_flops_fp32": PEAK_FLOPS_FP32}


def ridge_intensity(peak_flops: float = PEAK_FLOPS_FP32,
                    hbm_bw: float = HBM_BW) -> float:
    """FLOP/byte at the roofline ridge: intensity beyond this is
    compute-bound and more RHS reuse buys nothing."""
    return peak_flops / hbm_bw


def csr_stream_bytes(nnz: int, m: int, dtype_bytes: int = 4) -> int:
    """Ideal CSR matrix-stream footprint of one multiply: values + column
    indices + row pointer."""
    return nnz * (4 + dtype_bytes) + 4 * (m + 1)


def spmm_arithmetic_intensity(nnz: int, m: int, n: int, k: int,
                              matrix_bytes: Optional[int] = None,
                              dtype_bytes: int = 4) -> float:
    """Modelled FLOP/byte of one SpMM with k right-hand sides: every
    streamed matrix byte is reused across k columns."""
    if matrix_bytes is None:
        matrix_bytes = csr_stream_bytes(nnz, m, dtype_bytes)
    flops = 2.0 * nnz * k
    traffic = matrix_bytes + k * (m + n) * dtype_bytes
    return flops / max(traffic, 1)


def spmm_roofline_gflops(ai: float, peak_flops: float = PEAK_FLOPS_FP32,
                         hbm_bw: float = HBM_BW) -> float:
    """Attainable GFLOP/s at arithmetic intensity ``ai``: the lower of
    the peak and ``ai`` × the memory rate. The defaults are the H100's
    float32 peak and HBM rate (data sheet), the rates this package's SpMM
    kernels run at; the reference's defaults are a TPU's bf16 peak and
    HBM rate, so pass both to compare the two."""
    return min(peak_flops, ai * hbm_bw) / 1e9


def spmm_touched_fraction(n: int, nnz: int, num_devices: int = 1) -> float:
    """Modelled fraction of the ``n`` X rows one data shard's compacted
    gather reads: min(nnz / P, n) / n."""
    if n <= 0:
        return 0.0
    P = max(int(num_devices), 1)
    return min(float(nnz) / P, float(n)) / float(n)


def spmm_distributed_traffic(m: int, n: int, k: int, num_devices: int,
                             schedule: str,
                             matrix_bytes: Optional[float] = None,
                             nnz: int = 0, dtype_bytes: int = 4,
                             max_row_nnz: int = 0, model_devices: int = 1,
                             compact_x: bool = False,
                             n_touched: Optional[float] = None,
                             op: str = "N",
                             structure: str = "general"
                             ) -> Tuple[float, float]:
    """(per-device HBM bytes, per-device collective bytes) of one k-RHS
    SpMM under the two paper schedules — ``"row"`` (banded, dense-row
    floor, no collective) and ``"merge"`` (equal-nnz spans, full-partial
    write, all-reduce fixup ≈ 2·m·k bytes). ``num_devices == 1`` is the
    single-device stream: matrix + X + Y bytes, no collective. See the
    reference's docstring for the 2-D mesh, compact-X, transpose and
    symmetric terms, which are carried over unchanged."""
    if schedule not in ("row", "merge"):
        raise ValueError(f"schedule must be 'row' or 'merge', got "
                         f"{schedule!r}")
    if op not in ("N", "T"):
        raise ValueError(f"op must be 'N' or 'T', got {op!r}")
    if structure not in ("general", "symmetric"):
        raise ValueError(f"structure must be 'general' or 'symmetric', "
                         f"got {structure!r}")
    if matrix_bytes is None:
        matrix_bytes = float(csr_stream_bytes(nnz, m, dtype_bytes))
    if structure == "symmetric":
        if m != n:
            raise ValueError(f"structure='symmetric' needs a square "
                             f"matrix, got {m}x{n}")
        half = 0.5 * float(matrix_bytes) + float(m) * dtype_bytes
        hbm, coll_n = spmm_distributed_traffic(
            m, n, k, num_devices, schedule, matrix_bytes=half, nnz=nnz,
            dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
            model_devices=model_devices, compact_x=compact_x,
            n_touched=n_touched, op="N")
        _, coll_t = spmm_distributed_traffic(
            m, n, k, num_devices, schedule, matrix_bytes=half, nnz=nnz,
            dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
            model_devices=model_devices, compact_x=compact_x,
            n_touched=n_touched, op="T")
        return hbm, coll_n + coll_t
    P = max(int(num_devices), 1)
    Pm = max(int(model_devices), 1)
    kc = float(k) / Pm
    if op == "T":
        x_bytes = float(m) * kc * dtype_bytes
        if P == 1:
            return (matrix_bytes + x_bytes
                    + float(n) * kc * dtype_bytes), 0.0
        stream = matrix_bytes / P
        if schedule == "row":
            stream = max(stream, float(max_row_nnz) * (4 + dtype_bytes))
        if compact_x:
            nt = (min(float(n_touched), float(n)) if n_touched is not None
                  else spmm_touched_fraction(n, nnz, P) * float(n))
            return stream + x_bytes + nt * kc * dtype_bytes, \
                nt * kc * dtype_bytes
        y_bytes = float(n) * kc * dtype_bytes
        return stream + x_bytes + y_bytes, 2.0 * float(n) * kc * dtype_bytes
    if compact_x:
        nt = (min(float(n_touched), float(n)) if n_touched is not None
              else spmm_touched_fraction(n, nnz, P) * float(n))
        x_bytes = nt * kc * dtype_bytes
    else:
        x_bytes = float(n) * kc * dtype_bytes
    if P == 1:
        return matrix_bytes + x_bytes + float(m) * kc * dtype_bytes, 0.0
    if schedule == "row":
        stream = max(matrix_bytes / P,
                     float(max_row_nnz) * (4 + dtype_bytes))
        y_bytes = (float(m) / P) * kc * dtype_bytes
        return stream + x_bytes + y_bytes, 0.0
    stream = matrix_bytes / P
    y_bytes = float(m) * kc * dtype_bytes
    psum_bytes = 2.0 * float(m) * kc * dtype_bytes
    return stream + x_bytes + y_bytes, psum_bytes


# Fixed cost of issuing one collective (launch + ring sync).
COLLECTIVE_LAUNCH_S = 1e-6


def spmm_distributed_collective_s(m: int, n: int, k: int, num_devices: int,
                                  schedule: str,
                                  matrix_bytes: Optional[float] = None,
                                  nnz: int = 0, dtype_bytes: int = 4,
                                  max_row_nnz: int = 0, num_chunks: int = 1,
                                  hbm_bw: float = HBM_BW,
                                  link_bw: float = NVLINK_BW,
                                  model_devices: int = 1,
                                  compact_x: bool = False,
                                  n_touched: Optional[float] = None,
                                  op: str = "N",
                                  structure: str = "general") -> float:
    """EXPOSED collective seconds of one distributed multiply: with
    ``num_chunks = c`` per-chunk wire time ``tl = coll_s/c + launch``
    overlaps per-chunk compute ``tc = hbm_s/c`` and the pipeline exposes
    ``(c-1) * max(0, tl - tc) + tl``."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    hbm, coll = spmm_distributed_traffic(
        m, n, k, num_devices, schedule, matrix_bytes=matrix_bytes, nnz=nnz,
        dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
        model_devices=model_devices, compact_x=compact_x,
        n_touched=n_touched, op=op, structure=structure)
    if coll <= 0.0:
        return 0.0
    c = int(num_chunks)
    tl = coll / link_bw / c + COLLECTIVE_LAUNCH_S
    tc = (hbm / hbm_bw) / c
    return (c - 1) * max(0.0, tl - tc) + tl


def spmm_distributed_gather_s(m: int, n: int, k: int, num_devices: int,
                              schedule: str,
                              matrix_bytes: Optional[float] = None,
                              nnz: int = 0, dtype_bytes: int = 4,
                              max_row_nnz: int = 0, num_chunks: int = 1,
                              hbm_bw: float = HBM_BW,
                              model_devices: int = 1,
                              compact_x: bool = False,
                              n_touched: Optional[float] = None,
                              op: str = "N",
                              structure: str = "general",
                              gather: str = "upfront") -> float:
    """EXPOSED seconds of building the compact-X slab: all of it up front,
    span 0's share plus what compute cannot cover when overlapped, none
    when fused; zero without a compact partition or for ``op='T'``."""
    if gather not in ("upfront", "overlap", "fused"):
        raise ValueError(f"gather must be 'upfront', 'overlap' or 'fused', "
                         f"got {gather!r}")
    if not compact_x or op == "T" or gather == "fused":
        return 0.0
    P = max(int(num_devices), 1)
    Pm = max(int(model_devices), 1)
    kc = float(k) / Pm
    nt = (min(float(n_touched), float(n)) if n_touched is not None
          else spmm_touched_fraction(n, nnz, P) * float(n))
    t_g = 2.0 * nt * kc * dtype_bytes / hbm_bw
    c = int(num_chunks)
    if gather == "overlap" and schedule == "merge" and c > 1:
        hbm, _ = spmm_distributed_traffic(
            m, n, k, num_devices, schedule, matrix_bytes=matrix_bytes,
            nnz=nnz, dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
            model_devices=model_devices, compact_x=compact_x,
            n_touched=n_touched, op=op, structure=structure)
        tc = (hbm / hbm_bw) / c
        return t_g / c + (c - 1) * max(0.0, t_g / c - tc)
    return t_g


def spmm_distributed_time(m: int, n: int, k: int, num_devices: int,
                          schedule: str,
                          matrix_bytes: Optional[float] = None,
                          nnz: int = 0, dtype_bytes: int = 4,
                          max_row_nnz: int = 0, num_chunks: int = 1,
                          hbm_bw: float = HBM_BW,
                          link_bw: float = NVLINK_BW,
                          model_devices: int = 1,
                          compact_x: bool = False,
                          n_touched: Optional[float] = None,
                          op: str = "N",
                          structure: str = "general",
                          gather: str = "upfront") -> float:
    """Modelled seconds per multiply: HBM term + the exposed collective
    term + the exposed gather term. On one device it is the streaming-bytes
    roofline of the format: (matrix + X + Y bytes) / HBM bandwidth."""
    hbm, _ = spmm_distributed_traffic(
        m, n, k, num_devices, schedule, matrix_bytes=matrix_bytes, nnz=nnz,
        dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
        model_devices=model_devices, compact_x=compact_x,
        n_touched=n_touched, op=op, structure=structure)
    return hbm / hbm_bw + spmm_distributed_collective_s(
        m, n, k, num_devices, schedule, matrix_bytes=matrix_bytes, nnz=nnz,
        dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
        num_chunks=num_chunks, hbm_bw=hbm_bw, link_bw=link_bw,
        model_devices=model_devices, compact_x=compact_x,
        n_touched=n_touched, op=op, structure=structure
    ) + spmm_distributed_gather_s(
        m, n, k, num_devices, schedule, matrix_bytes=matrix_bytes, nnz=nnz,
        dtype_bytes=dtype_bytes, max_row_nnz=max_row_nnz,
        num_chunks=num_chunks, hbm_bw=hbm_bw,
        model_devices=model_devices, compact_x=compact_x,
        n_touched=n_touched, op=op, structure=structure, gather=gather)
