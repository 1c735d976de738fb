// K1 — SELL-C-sigma slot-space SpMM on Hopper (sm_90a).
//
// Replaces: repro/spmm/kernels.py `sellcs_slots` / `_sellcs_kernel`, the
// Pallas TPU kernel that computes
//     Y[slice_of[w] * C + l, :] += data[w, l] * X[cols[w, l], :]
// over a k-tiled grid, eight width-rows per grid step, with the Y slab
// resident in VMEM across the sequential matrix-stream axis.
//
// Bound on this card: bytes. The function needs 4 B value + 4 B column
// per nonzero and one row offset per row, X read once and Y written once;
// at 2 flops per nonzero and column the intensity stays far below the
// H100's f32 ridge (~20 flop/byte), so the least time is those bytes over
// 3.35 TB/s. The padding slots of the SELL stream (1 - fill of it) are
// this format's overhead on top of that bound.
//
// Design: the TPU kernel carries its sum across grid steps in VMEM; here
// blocks run in no order, so each output slot is owned by exactly one
// thread. Block (s, b) serves slice s; its threads cover consecutive
// (lane, column) pairs of the slice's C x k slot block, lane-major, so a
// warp reads one row of X (k consecutive floats) when k >= 32 and 32
// consecutive lanes of data/cols when k == 1. Each thread walks the
// slice's width-rows slice_ptr[s] .. slice_ptr[s+1] in order and keeps its
// sum in a register: no atomics, no shared memory, and the order of the
// adds per slot is the reference's (width-row order). Padding entries
// (data == 0, cols == 0) add zero.
//
// Simple and correct first: no TMA/wgmma, no software pipelining beyond
// the unrolled loop (a later, measured change).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
sellcs_slots_kernel(const float* __restrict__ data,
                    const int* __restrict__ cols,
                    const int* __restrict__ slice_ptr,
                    const float* __restrict__ x,
                    float* __restrict__ y, int chunk, int k) {
  const int s = blockIdx.x;
  const long long t = (long long)blockIdx.y * kBlock + threadIdx.x;
  const long long per_slice = (long long)chunk * k;
  if (t >= per_slice) return;
  const int lane = (int)(t / k);
  const int j = (int)(t - (long long)lane * k);
  const int w0 = slice_ptr[s];
  const int w1 = slice_ptr[s + 1];
  const float* dp = data + (long long)w0 * chunk + lane;
  const int* cp = cols + (long long)w0 * chunk + lane;
  float acc = 0.f;
#pragma unroll 4
  for (int w = w0; w < w1; ++w) {
    acc = fmaf(*dp, x[(long long)(*cp) * k + j], acc);
    dp += chunk;
    cp += chunk;
  }
  y[((long long)s * chunk + lane) * k + j] = acc;
}

}  // namespace

extern "C" {

// data f32[W, C], cols i32[W, C], slice_ptr i32[S+1], x f32[n, k],
// y f32[S*C, k] (every element written). Returns cudaGetLastError().
int sellcs_slots_launch(const float* data, const int* cols,
                        const int* slice_ptr, const float* x, float* y,
                        int num_slices, int chunk, int k, void* stream) {
  if (num_slices <= 0 || chunk <= 0 || k <= 0) return 0;
  const long long per_slice = (long long)chunk * k;
  const long long blocks_y = (per_slice + kBlock - 1) / kBlock;
  if (blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)num_slices, (unsigned)blocks_y);
  sellcs_slots_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      data, cols, slice_ptr, x, y, chunk, k);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
