// K1 — SELL-C-sigma slot-space SpMM on Hopper (sm_90a),
// K8 — the same with the compact-X gather fused in, and
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
//
// K8 replaces: repro/spmm/kernels.py `sellcs_slots(col_map=...)` /
// `_sellcs_fused_kernel`, the `gather="fused"` mode of the distributed
// multiplies: a shard's stored cols are compact ids into its touched
// column set, and col_map (riding the TPU's scalar prefetch) names the row
// of the full X each one reads:
//     Y[s * C + l, :] += data[w, l] * X[col_map[cols[w, l]], :]
// Bound on this card: bytes, as K1, plus one int32 of col_map per touched
// column; X is read only at the touched rows. Design: K1's body with one
// more load per (width-row, lane) — gcol = col_map[cols[w, l]] — before the
// read of X. The adds per slot keep K1's order, so the fused gather and
// the up-front slab (x[col_map], then K1 on compact ids) give bitwise-equal
// results, as the reference's gather modes do.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <bool kFused>
__global__ void __launch_bounds__(kBlock)
sellcs_slots_kernel(const float* __restrict__ data,
                    const int* __restrict__ cols,
                    const int* __restrict__ col_map,
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
    const int c = kFused ? col_map[*cp] : *cp;
    acc = fmaf(*dp, x[(long long)c * k + j], acc);
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
// order, Y written once), 2 flops per stored nonzero and column. What
// sets the pace in practice is Y's read-modify-write: each nonzero adds a
// k-wide row into Y[cols[w, l], :] at a column the stream does not order,
// and at k = 32 on a million columns Y is 128 MiB, past the 50 MB L2, so
// most of those lines travel to HBM and back unless the adds go in bands.
//
// Design: the one-hot is O(C * n) work per width-row and is not carried
// over. Each product is added straight into Y with an f32 atomic add
// (RED, its result unused) into a Y the wrapper zeroes; the order of the
// adds into one element varies from run to run, so the result is not
// bitwise reproducible.
//   * Work items: the width-row stream is cut into depth chunks of
//     kTDepth width-rows, and a warp owns one chunk's 32 consecutive
//     lanes (one lane group of the C lanes). A deep slice (mawi_like's
//     dense row, hundreds of thousands of width-rows) is thus spread over
//     as many warps as its depth asks for; a chunk that crosses slices
//     walks them as runs, one slice at a time. 16 deep: 32 paid for the
//     runs of narrow slices (road_like, k = 1), 8 for the per-run set-up
//     on deep ones (mawi_like).
//   * Stream: the data/cols of kTUnroll width-rows are loaded at once,
//     one coalesced load per lane; the live entries of a width-row (a
//     ballot mask) are compacted into the warp's shared memory, and the
//     warp adds only those. At k >= 32 with k % 4 == 0 a thread adds four
//     columns with one 16-byte atomic (RED.v4): at k = 32 eight threads
//     cover an entry's 128-byte row of Y and a warp adds four entries a
//     step, a quarter of the instructions of one column a thread (the
//     same at k = 8 and 16 won at one matrix and lost at two). Otherwise
//     a thread adds one column: at k >= 32 an entry is a row of the 32
//     threads, below that 32 / KC entries of KC columns a step (KC the
//     next power of two of k); at k = 1 each thread adds its own lane's
//     entry. So a padding or out-of-band entry costs a bit of a mask, not
//     instructions, and no integer division by k is left in the loop.
//   * x_slots: the rows of the run's lanes at the warp's columns (up to
//     64; k > 64 takes column blocks on grid.y, each reading the stream
//     again) are staged into shared memory once per run, at its first
//     width-row that adds anything; at k = 1 the own lane's value is a
//     register, loaded beside the lane's length.
//   * Padding: rows are sigma-sorted by descending length, and the walk
//     stops at the longest length of the warp's lanes (a warp-wide max of
//     row_len), so the padding width-rows below every lane cost nothing.
//   * Column bands: the kernel adds only the entries whose column lies
//     in [col_lo, col_hi). The entry point runs one pass per band of Y's
//     columns, so a Y larger than L2 (128 MiB at hhh_like 64, k = 32) is
//     updated one L2-sized band at a time: a pass into a Y that stays in
//     L2 takes 0.58 of the 1.52 ms of one pass into the whole Y (PERF.md,
//     PR 18), and with adds that cost a mask bit each a pass over the
//     stream costs little. The wrapper picks the count from L2's size.
// Tried and dropped (PERF.md, PR 18): a register-held x with the 32
// lanes walked as an unrolled predicated loop (every padding lane cost
// instructions, so band passes did not pay), depth chunks of 8 and 32.
// Not yet: a pre-reduction of adds to one column, a band count that
// sees the columns' locality (a column-local matrix needs one pass).
//
// The stream must be the real width-row prefix (slice ids nondecreasing),
// as every caller hands it: slice_ptr[s] is the depth base of slice s, so
// the width-rows of slice s are [max(slice_ptr[s], 0), slice_ptr[s + 1])
// and a stream cut mid-slice (a merge-span shard) starts with a negative
// base.

constexpr int kTWarps = 4;     // warps per block
constexpr int kTDepth = 16;    // width-rows per work item
constexpr int kTUnroll = 4;    // width-rows loaded ahead
constexpr unsigned kFull = 0xffffffffu;

// One warp's shared memory: the x_slots values of its 32 lanes at its
// columns, and the live entries of one width-row, compacted.
// One 16-byte f32 atomic add (RED.v4, Hopper): four columns of Y.
__device__ __forceinline__ void red_add_v4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

template <int KW> struct __align__(16) TWarpSmem {
  float x[32][KW];
  float d[32];
  int c[32];
  int lane[32];
};

template <int KC, int G>
__global__ void __launch_bounds__(kTWarps * 32)
sellcs_slots_t_kernel(const float* __restrict__ data,
                      const int* __restrict__ cols,
                      const int* __restrict__ slice_of,
                      const int* __restrict__ slice_ptr,
                      const int* __restrict__ row_len,
                      const float* __restrict__ xs,
                      float* __restrict__ y, int width_rows, int chunk,
                      int k, int lane_groups, long long items, int col_lo,
                      int col_hi) {
  constexpr int kLanesPerStep = 32 / KC;     // entries a warp adds a step
  constexpr int KW = KC * G;                 // columns a pass holds
  __shared__ TWarpSmem<KW> smem_all[kTWarps];
  TWarpSmem<KW>& sm = smem_all[threadIdx.x >> 5];
  const int t = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kTWarps + (threadIdx.x >> 5);
  if (item >= items) return;
  const int g = (int)(item % lane_groups);
  const long long tile = item / lane_groups;
  const int sub = t / KC;                       // KC is a power of two
  const int jc = t % KC;
  const int col0 = blockIdx.y * KW;             // first column of the pass
  const int my_lane = g * 32 + t;               // the lane this thread loads
  const bool lane_ok = my_lane < chunk;
  const unsigned below = (1u << t) - 1u;        // lanes under this one

  long long w = tile * kTDepth;
  const long long w_tile_end = min(w + kTDepth, (long long)width_rows);
  while (w < w_tile_end) {
    const int s = slice_of[w];
    const long long base = slice_ptr[s];        // depth 0 of slice s
    const long long run_end =
        min(w_tile_end, max((long long)slice_ptr[s + 1], w + 1));
    const long long slot0 = (long long)s * chunk + g * 32;
    const int len = lane_ok ? row_len[slot0 + t] : 0;
    // KC == 1: the own lane's x, loaded beside its length (no wait)
    const float x_own = (KC == 1 && lane_ok) ? xs[slot0 + t] : 0.f;
    const long long w_stop =
        min(run_end, base + __reduce_max_sync(kFull, len));
    if (w < w_stop) {
      // the x_slots rows of the lanes with entries in this run are staged
      // at the first width-row that adds anything (a pass over another
      // column band often adds nothing here)
      const long long depth0 = w - base;
      bool staged = false;
      for (long long w0 = w; w0 < w_stop; w0 += kTUnroll) {
        float dv[kTUnroll];
        int cv[kTUnroll];
#pragma unroll
        for (int u = 0; u < kTUnroll; ++u) {
          const bool in = lane_ok && w0 + u < w_stop;
          const long long e = (w0 + u) * chunk + my_lane;
          dv[u] = in ? data[e] : 0.f;
          cv[u] = in ? cols[e] : -1;
        }
        bool real[kTUnroll];
#pragma unroll
        for (int u = 0; u < kTUnroll; ++u)
          real[u] = cv[u] >= col_lo && cv[u] < col_hi && w0 + u - base < len;
        if (KC == 1) {
#pragma unroll
          for (int u = 0; u < kTUnroll; ++u)
            if (real[u]) atomicAdd(y + cv[u], dv[u] * x_own);
          continue;
        }
        unsigned mask[kTUnroll];
        unsigned any = 0u;
#pragma unroll
        for (int u = 0; u < kTUnroll; ++u) {
          mask[u] = __ballot_sync(kFull, real[u]);
          any |= mask[u];
        }
        if (any == 0u) continue;                 // warp-uniform
        if (!staged) {
          __syncwarp();
#pragma unroll 8
          for (int q = 0; q < KW; ++q) {
            const int idx = t + 32 * q;
            const int i = idx / KW, j = idx % KW;   // lane, column
            const int i_len = __shfl_sync(kFull, len, i);
            sm.x[i][j] = (i_len > depth0 && col0 + j < k)
                             ? xs[(slot0 + i) * k + col0 + j] : 0.f;
          }
          staged = true;
        }
#pragma unroll
        for (int u = 0; u < kTUnroll; ++u) {
          if (mask[u] == 0u) continue;
          const int n = __popc(mask[u]);
          if (real[u]) {                 // compact the live entries
            const int r = __popc(mask[u] & below);
            sm.d[r] = dv[u];
            sm.c[r] = cv[u];
            sm.lane[r] = t;
          }
          __syncwarp();
          if constexpr (KC == 32) if ((k & 3) == 0) {
            // four columns a thread, one 16-byte add each
            constexpr int kTpe = KW / 4;           // threads per entry
            constexpr int kEps = 32 / kTpe;        // entries per step
            const int es = t / kTpe, cq = 4 * (t % kTpe);
            if (col0 + cq < k) {
              for (int e = es; e < n; e += kEps) {
                const float d = sm.d[e];
                const float4 xq =
                    *reinterpret_cast<const float4*>(&sm.x[sm.lane[e]][cq]);
                red_add_v4(y + (long long)sm.c[e] * k + col0 + cq,
                           make_float4(d * xq.x, d * xq.y, d * xq.z,
                                       d * xq.w));
              }
            }
            __syncwarp();
            continue;
          }
          for (int e = sub; e < n; e += kLanesPerStep) {
            const float d = sm.d[e];
            float* yr = y + (long long)sm.c[e] * k + col0 + jc;
            const float* xr = &sm.x[sm.lane[e]][jc];
#pragma unroll
            for (int gg = 0; gg < G; ++gg)
              if (col0 + jc + 32 * gg < k)
                atomicAdd(yr + 32 * gg, d * xr[32 * gg]);
          }
          __syncwarp();
        }
      }
    }
    w = run_end;
  }
}

template <int KC, int G>
cudaError_t launch_t(const float* data, const int* cols, const int* slice_of,
                     const int* slice_ptr, const int* row_len,
                     const float* xs, float* y, int width_rows, int chunk,
                     int k, int n_out, int bands, cudaStream_t stream) {
  const int lane_groups = (chunk + 31) / 32;
  const long long tiles = ((long long)width_rows + kTDepth - 1) / kTDepth;
  const long long items = tiles * lane_groups;
  const long long blocks = (items + kTWarps - 1) / kTWarps;
  const int col_blocks = (k + KC * G - 1) / (KC * G);
  if (blocks > 2147483647LL || col_blocks > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)col_blocks);
  const int band = (int)(((long long)n_out + bands - 1) / bands);
  for (int b = 0; b < bands; ++b) {
    const int lo = b * band;
    const int hi = b + 1 == bands ? n_out : lo + band;
    sellcs_slots_t_kernel<KC, G><<<grid, kTWarps * 32, 0, stream>>>(
        data, cols, slice_of, slice_ptr, row_len, xs, y, width_rows, chunk,
        k, lane_groups, items, lo, hi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  sellcs_slots_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      data, cols, nullptr, slice_ptr, x, y, chunk, k);
  return (int)cudaGetLastError();
}

// K8: as sellcs_slots_launch, with cols compact ids into col_map i32[Ntc]
// and x the full f32[n, k]. Returns cudaGetLastError().
int sellcs_slots_fused_launch(const float* data, const int* cols,
                              const int* col_map, const int* slice_ptr,
                              const float* x, float* y, int num_slices,
                              int chunk, int k, void* stream) {
  if (num_slices <= 0 || chunk <= 0 || k <= 0) return 0;
  const long long per_slice = (long long)chunk * k;
  const long long blocks_y = (per_slice + kBlock - 1) / kBlock;
  if (blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)num_slices, (unsigned)blocks_y);
  sellcs_slots_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      data, cols, col_map, slice_ptr, x, y, chunk, k);
  return (int)cudaGetLastError();
}

// data f32[W, C], cols i32[W, C], slice_of i32[W], slice_ptr i32[S+1]
// (each slice's depth base), row_len i32[S*C], xs f32[S*C, k] (X in slot
// order), y f32[n_out, k] zeroed by the caller; bands >= 1 passes, each
// over one band of Y's rows (the entries' columns). Returns
// cudaGetLastError() of the first failed launch, else 0.
int sellcs_slots_t_launch(const float* data, const int* cols,
                          const int* slice_of, const int* slice_ptr,
                          const int* row_len, const float* xs, float* y,
                          int width_rows, int chunk, int k, int n_out,
                          int bands, void* stream) {
  if (width_rows <= 0 || chunk <= 0 || k <= 0 || n_out <= 0) return 0;
  if (bands < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_K3(KC, G)                                                   \
  return (int)launch_t<KC, G>(data, cols, slice_of, slice_ptr, row_len,   \
                              xs, y, width_rows, chunk, k, n_out, bands,  \
                              st)
  if (k == 1) REPRO_K3(1, 1);
  if (k == 2) REPRO_K3(2, 1);
  if (k <= 4) REPRO_K3(4, 1);
  if (k <= 8) REPRO_K3(8, 1);
  if (k <= 16) REPRO_K3(16, 1);
  if (k <= 32) REPRO_K3(32, 1);
  REPRO_K3(32, 2);
#undef REPRO_K3
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
