// K1 — SELL-C-sigma slot-space SpMM on Hopper (sm_90a), and
// K3 — its transpose (further down).
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

// K3 — SELL-C-sigma transpose pass, Y = A^T X.
//
// Replaces: repro/spmm/kernels.py `sellcs_slots_t` / `_sellcs_t_kernel`,
// the Pallas TPU kernel in which each width-row w reads the C-block of
// slot-permuted X at slice_of[w] * C and scatters data[w, l] * x into
// Y[cols[w, l], :] through a one-hot (C, n_pad) contraction on the MXU.
//
// Bound on this card: bytes, like K1 (the same stream, X read in slot
// order, Y written once), 2 flops per stored nonzero and column.
//
// Design: the one-hot is O(C * n) work per width-row and is not carried
// over. Each (width-row, lane, column) product is added straight into
// Y[cols[w, l], j] with an f32 atomic add (RED, its result unused); Y is
// zeroed by the wrapper. The order of the adds into one element varies
// from run to run, so the result is not bitwise reproducible.
//   * Padding: padding entries carry data == 0, cols == 0 and would all
//     pile up on Y[0, :]. An entry is skipped when its depth in the slice,
//     w - slice_ptr[s], reaches the slot's true length row_len[s*C + l]
//     (this also skips the padding slots past row m, whose length is 0).
//   * Deep slices: the grid runs over tiles of width-rows, not over
//     slices, and reads slice_of[w] per width-row, so one slice hundreds
//     of thousands of width-rows deep (mawi_like's dense row) is spread
//     over as many blocks as its width asks for.
//   * Coalescing: a block walks its tile's (width-row, lane, column)
//     triples with the column fastest. For k >= 32 a warp covers 32
//     consecutive columns of one (width-row, lane): one 128-byte line of
//     x_slots read and one line of Y updated. For k == 1 a warp covers 32
//     consecutive lanes of one width-row, so data and cols are read
//     coalesced.
// Simple and correct first: no shared-memory pre-reduction of the
// scattered adds (a later, measured change; see PERF.md).

constexpr int kTileElems = 8192;   // (width-row, lane, column) per block

__global__ void __launch_bounds__(kBlock)
sellcs_slots_t_kernel(const float* __restrict__ data,
                      const int* __restrict__ cols,
                      const int* __restrict__ slice_of,
                      const int* __restrict__ slice_ptr,
                      const int* __restrict__ row_len,
                      const float* __restrict__ xs,
                      float* __restrict__ y, int width_rows, int chunk,
                      int k, int rows_per_block) {
  const long long w_first = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block,
                            (long long)width_rows - w_first);
  const int per_row = chunk * k;
  const int total = rows * per_row;
  for (int idx = threadIdx.x; idx < total; idx += kBlock) {
    const int r = idx / per_row;
    const int rem = idx - r * per_row;
    const int lane = rem / k;
    const int j = rem - lane * k;
    const long long w = w_first + r;
    const int s = slice_of[w];
    const long long slot = (long long)s * chunk + lane;
    if (w - slice_ptr[s] >= row_len[slot]) continue;   // padding entry
    const long long e = w * chunk + lane;
    atomicAdd(y + (long long)cols[e] * k + j, data[e] * xs[slot * k + j]);
  }
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

// data f32[W, C], cols i32[W, C], slice_of i32[W], slice_ptr i32[S+1],
// row_len i32[S*C], xs f32[S*C, k] (X in slot order), y f32[n, k] zeroed
// by the caller. Returns cudaGetLastError().
int sellcs_slots_t_launch(const float* data, const int* cols,
                          const int* slice_of, const int* slice_ptr,
                          const int* row_len, const float* xs, float* y,
                          int width_rows, int chunk, int k, void* stream) {
  if (width_rows <= 0 || chunk <= 0 || k <= 0) return 0;
  const long long per_row = (long long)chunk * k;
  if (per_row > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int rows_per_block =
      (int)(per_row >= kTileElems ? 1 : kTileElems / per_row);
  const long long blocks =
      ((long long)width_rows + rows_per_block - 1) / rows_per_block;
  sellcs_slots_t_kernel<<<(unsigned)blocks, kBlock, 0,
                          (cudaStream_t)stream>>>(
      data, cols, slice_of, slice_ptr, row_len, xs, y, width_rows, chunk, k,
      rows_per_block);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
