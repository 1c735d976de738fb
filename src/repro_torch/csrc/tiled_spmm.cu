// K5 — SpMV over dense 8x128 mini-tiles (TiledSparse), and
// K6/K7 — its multi-RHS forms, on Hopper (sm_90a).
//
// Replaces:
//   K5  repro/kernels/bsr_spmv.py `bsr_spmv` / `_kernel`
//   K6  repro/spmm/kernels.py `tiled_spmm` / `_tiled_kernel`
//   K7  repro/kernels/bsr_spmv.py `bsr_spmm` / `_kernel_spmm`
// Each Pallas kernel walks the stored mini-tiles on a sequential grid and
// adds tile(8x128) @ X[c*128 : +128, cols] into a VMEM-resident Y slab at
// rows r*8 : +8. X is rounded to the tile dtype (f32 or bf16) before the
// product; products accumulate in f32 and Y is f32. K6's grid has a
// leading k-tile axis of width KT; K7 is the same product with the whole
// RHS width R in one block (KT = R).
//
// Bound on this card: the function needs the CSR bytes of the matrix
// plus X and Y; the format itself streams 4 KiB (f32) per stored tile,
// 100-1000x more at fill ratios of 1e-3..1e-2, so the stream is what a
// kernel of this format can approach: tile bytes over 3.35 TB/s. At
// k = 32 the dense tile math (2 * 1024 * k flops per tile) is as large as
// that stream time at the f32 FMA rate, so K6/K7 sit near the ridge.
//
// Design:
//   * Order and reduction. The TPU grid runs in order and every step adds
//     into one y. Here each block (K6/K7) or warp (K5) takes a contiguous
//     run of the stored stream, so the visit order of the paper algorithm
//     that ordered the tiles stays the stream order. Consecutive tiles of
//     one tile-row (a row-ordered stream) are summed in registers; when
//     the tile-row changes the sums are reduced over the warp and added
//     into Y with f32 atomic adds (RED) into a Y the wrapper zeroed. So
//     the number of atomics follows the stream's y-window switches, and
//     the order of the adds, and the last bits, vary from run to run.
//   * K5: one warp per run of 8 tiles. Each lane takes 4 of the 128 tile
//     columns: one float4 of x and, per tile row, 4 tile values (a float4
//     of f32 or 8 bytes of bf16), with 8 row sums in registers.
//   * K6/K7: one 256-thread block per (run of 8 tiles, column tile). The
//     tile is staged in shared memory as f32 (one 16-byte load per
//     thread); warp i owns tile row i. Columns go in passes of up to 32:
//     a pass of w columns rounds w up to a power of two cp, lane l takes
//     column l % cp and every (32/cp)-th tile column from l / cp, so a
//     warp reads 32/cp consecutive X rows of cp consecutive floats
//     (coalesced when cp = k), and the shares are summed with shuffles at
//     the flush. Up to 4 passes (128 columns) keep their sums in
//     registers per staged tile; a wider column tile stages each tile
//     again per 128 columns.
//   * X rows past n (the ragged last tile column) are read as zero; Y is
//     allocated with the padded row count m_pad = 8 * ceil(m / 8).
// Simple and correct first: FP32 FMA, no tensor cores, no TMA or double
// buffering (later, measured changes; see PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kTileR = 8;
constexpr int kTileC = 128;
constexpr int kTileElems = kTileR * kTileC;
constexpr unsigned kFull = 0xffffffffu;

// tile dtype codes (repro_torch.kernels.bsr_spmv._DTYPE_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <int DT> struct Tile;

template <> struct Tile<kF32> {
  using T = float;
  // four consecutive tile values (16-byte aligned)
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float round_x(float v) { return v; }
};

template <> struct Tile<kBF16> {
  using T = unsigned short;   // bf16 bits
  // four consecutive bf16 values (8-byte aligned); a bf16 is the high half
  // of the f32 with the same bits, element 0 in the low half-word
  static __device__ __forceinline__ float4 load4(const unsigned short* p) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
  }
  // round to the nearest bf16, ties to even (what torch's .to(bfloat16)
  // and XLA's convert do); x is finite here
  static __device__ __forceinline__ float round_x(float v) {
    unsigned u = __float_as_uint(v);
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
  }
};

// ---------------------------------------------------------------- K5 ----
constexpr int kSpmvWarps = 8;      // warps per block
constexpr int kSpmvRun = 8;        // consecutive tiles per warp

// Sum each row's partials over the warp; lane i adds row i's sum into
// y[row * 8 + i]; the partials restart from zero.
__device__ __forceinline__ void flush_rows(float (&acc)[kTileR], float* y,
                                           int row, int lane) {
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < kTileR; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == i) mine = v;
    acc[i] = 0.f;
  }
  if (lane < kTileR) atomicAdd(y + (long long)row * kTileR + lane, mine);
}

template <int DT>
__global__ void __launch_bounds__(kSpmvWarps * 32)
tiled_spmv_kernel(const typename Tile<DT>::T* __restrict__ tiles,
                  const int* __restrict__ tile_rows,
                  const int* __restrict__ tile_cols,
                  const float* __restrict__ x, float* __restrict__ y,
                  int num_tiles, int n) {
  const int lane = threadIdx.x & 31;
  const long long t0 =
      ((long long)blockIdx.x * kSpmvWarps + (threadIdx.x >> 5)) * kSpmvRun;
  if (t0 >= num_tiles) return;                     // whole warp
  const long long t1 = min(t0 + kSpmvRun, (long long)num_tiles);
  float acc[kTileR];
#pragma unroll
  for (int i = 0; i < kTileR; ++i) acc[i] = 0.f;
  int row = tile_rows[t0];
  for (long long t = t0; t < t1; ++t) {
    const int r = tile_rows[t];
    if (r != row) {
      flush_rows(acc, y, row, lane);
      row = r;
    }
    const long long xc = (long long)tile_cols[t] * kTileC + lane * 4;
    float4 xv;
    if (xc + 4 <= n) {
      xv = __ldg(reinterpret_cast<const float4*>(x + xc));
    } else {
      xv.x = xc < n ? x[xc] : 0.f;
      xv.y = xc + 1 < n ? x[xc + 1] : 0.f;
      xv.z = xc + 2 < n ? x[xc + 2] : 0.f;
      xv.w = xc + 3 < n ? x[xc + 3] : 0.f;
    }
    xv.x = Tile<DT>::round_x(xv.x);
    xv.y = Tile<DT>::round_x(xv.y);
    xv.z = Tile<DT>::round_x(xv.z);
    xv.w = Tile<DT>::round_x(xv.w);
    const typename Tile<DT>::T* tp = tiles + t * kTileElems + lane * 4;
#pragma unroll
    for (int i = 0; i < kTileR; ++i) {
      const float4 a = Tile<DT>::load4(tp + i * kTileC);
      acc[i] = fmaf(a.x, xv.x, acc[i]);
      acc[i] = fmaf(a.y, xv.y, acc[i]);
      acc[i] = fmaf(a.z, xv.z, acc[i]);
      acc[i] = fmaf(a.w, xv.w, acc[i]);
    }
  }
  flush_rows(acc, y, row, lane);
}

// ------------------------------------------------------------ K6 / K7 ----
constexpr int kSpmmThreads = 256;  // 8 warps: warp i owns tile row i
constexpr int kSpmmRun = 8;        // consecutive tiles per block
constexpr int kPassCols = 32;      // columns per pass (one warp wide)
constexpr int kMaxPasses = 4;      // passes summed per staged tile

template <int DT>
__global__ void __launch_bounds__(kSpmmThreads)
tiled_spmm_kernel(const typename Tile<DT>::T* __restrict__ tiles,
                  const int* __restrict__ tile_rows,
                  const int* __restrict__ tile_cols,
                  const float* __restrict__ x, float* __restrict__ y,
                  int num_tiles, int n, int k, int kt) {
  __shared__ float4 stage[kTileElems / 4];         // one tile, f32, 4 KiB
  const long long t0 = (long long)blockIdx.x * kSpmmRun;
  const long long t1 = min(t0 + kSpmmRun, (long long)num_tiles);
  const int i = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j_begin = blockIdx.y * kt;
  const int j_end = min(j_begin + kt, k);
  const float* srow = reinterpret_cast<const float*>(stage) + i * kTileC;

  for (int g = j_begin; g < j_end; g += kPassCols * kMaxPasses) {
    const int g_end = min(g + kPassCols * kMaxPasses, j_end);
    const int passes = (g_end - g + kPassCols - 1) / kPassCols;
    int cp[kMaxPasses], col[kMaxPasses], share[kMaxPasses];
    bool on[kMaxPasses];
    float acc[kMaxPasses];
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      const int jb = g + p * kPassCols;
      const int width = max(0, min(kPassCols, g_end - jb));
      int c = 1;
      while (c < width) c <<= 1;
      cp[p] = c;
      col[p] = jb + (lane & (c - 1));
      share[p] = lane / c;
      on[p] = (lane & (c - 1)) < width;
      acc[p] = 0.f;
    }
    int row = tile_rows[t0];
    for (long long t = t0; t <= t1; ++t) {
      const int r = t < t1 ? tile_rows[t] : -1;
      if (r != row) {                              // flush (uniform)
#pragma unroll
        for (int p = 0; p < kMaxPasses; ++p) {
          if (p >= passes) break;
          float v = acc[p];
          for (int off = cp[p]; off < 32; off <<= 1)
            v += __shfl_xor_sync(kFull, v, off);
          if (on[p] && share[p] == 0)
            atomicAdd(y + ((long long)row * kTileR + i) * k + col[p], v);
          acc[p] = 0.f;
        }
        row = r;
      }
      if (t == t1) break;
      __syncthreads();                             // readers of the last tile
      stage[threadIdx.x] =
          Tile<DT>::load4(tiles + t * kTileElems + threadIdx.x * 4);
      __syncthreads();
      const long long x0 = (long long)tile_cols[t] * kTileC;
      const int lim = (int)min((long long)kTileC, (long long)n - x0);
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        if (p >= passes || !on[p]) continue;
        const int stride = kPassCols / cp[p];
        const float* xp = x + x0 * k + col[p];
        float a = acc[p];
#pragma unroll 8
        for (int l = share[p]; l < lim; l += stride)
          a = fmaf(srow[l], Tile<DT>::round_x(xp[(long long)l * k]), a);
        acc[p] = a;
      }
    }
  }
}

}  // namespace

extern "C" {

// K5. tiles [T, 8, 128] (tile_dtype 0 = f32, 1 = bf16; 16-byte aligned),
// tile_rows / tile_cols i32[T], x f32[n] (16-byte aligned), y f32[m_pad]
// zeroed by the caller. Returns cudaGetLastError().
int tiled_spmv_launch(const void* tiles, int tile_dtype, const int* tile_rows,
                      const int* tile_cols, const float* x, float* y,
                      int num_tiles, int n, void* stream) {
  if (num_tiles <= 0) return 0;
  const long long warps = ((long long)num_tiles + kSpmvRun - 1) / kSpmvRun;
  const long long blocks = (warps + kSpmvWarps - 1) / kSpmvWarps;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_dtype == kF32) {
    tiled_spmv_kernel<kF32><<<(unsigned)blocks, kSpmvWarps * 32, 0, s>>>(
        (const float*)tiles, tile_rows, tile_cols, x, y, num_tiles, n);
  } else if (tile_dtype == kBF16) {
    tiled_spmv_kernel<kBF16><<<(unsigned)blocks, kSpmvWarps * 32, 0, s>>>(
        (const unsigned short*)tiles, tile_rows, tile_cols, x, y, num_tiles,
        n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6 (kt = the column tile) and K7 (kt = k). tiles as above, x f32[n, k],
// y f32[m_pad, k] zeroed by the caller. Returns cudaGetLastError().
int tiled_spmm_launch(const void* tiles, int tile_dtype, const int* tile_rows,
                      const int* tile_cols, const float* x, float* y,
                      int num_tiles, int n, int k, int kt, void* stream) {
  if (num_tiles <= 0 || k <= 0) return 0;
  if (kt <= 0) return (int)cudaErrorInvalidValue;
  const long long runs = ((long long)num_tiles + kSpmmRun - 1) / kSpmmRun;
  const long long col_tiles = ((long long)k + kt - 1) / kt;
  if (col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)runs, (unsigned)col_tiles);
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_dtype == kF32) {
    tiled_spmm_kernel<kF32><<<grid, kSpmmThreads, 0, s>>>(
        (const float*)tiles, tile_rows, tile_cols, x, y, num_tiles, n, k, kt);
  } else if (tile_dtype == kBF16) {
    tiled_spmm_kernel<kBF16><<<grid, kSpmmThreads, 0, s>>>(
        (const unsigned short*)tiles, tile_rows, tile_cols, x, y, num_tiles,
        n, k, kt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
