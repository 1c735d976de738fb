// K9 — grouped (expert-blocked) GEMM for MoE dispatch, on Hopper (sm_90a).
//
// Replaces: repro/kernels/moe_group_matmul.py `moe_group_matmul_padded` /
// `_kernel`. The tokens of an MoE layer are sorted by expert and every
// expert's group is padded to 128 rows, so each 128-row m-tile belongs to
// one expert; the Pallas kernel prefetches the tile's expert id and runs
// a 128^3-tiled product of the tile against that expert's weight block,
// accumulating in f32:
//     out[i*128 : +128, :] = lhs[i*128 : +128, :] @ rhs[tile_expert[i]]
// lhs is bf16 (the full configs' activations) or f32, rhs is f32 (the
// weights are never cast on this path), and each lhs value is taken to f32
// exactly, so every product and sum is an f32 FMA.
//
// Bound on this card, for one MoE layer's three products (gate, up: K =
// d_model, N = d_ff; down: K = d_ff, N = d_model) over T * top_k rows:
//   * decode (granite, 32 tokens, 256 rows): bytes-bound — every used
//     expert's f32 weights are read once (67 MB per product), 0.061 ms at
//     3.35 TB/s against 0.8 GFLOP;
//   * prefill (4,096 tokens, 32,768 rows): operations-bound — 103 GFLOP
//     of f32 FMA at 67 TFLOP/s is 1.54 ms against 0.19 ms of bytes. A bf16
//     or TF32 tensor-core product would round the f32 weights that the
//     reference multiplies exactly, so the f32 FMA rate is the honest peak.
// Two kernels compute it; kernels.ops.moe_group_matmul picks one from the
// shapes (rows against experts), so the host never syncs:
//
// The tiled kernel (prefill: full tiles):
//   * One 256-thread block per (128-row m-tile, 128-column n-tile), on a
//     1-D grid (up to 2^31 - 1 blocks, so T_pad has no practical cap) with
//     the n-tiles of one m-tile adjacent. The m-tiles past the real length
//     then start last. The block reads its own tile_expert entry (no
//     scalar prefetch) and clamps it to [0, E), as the reference's gathers
//     clamp.
//   * The K loop goes in slabs of 32: the lhs slab (converted to f32) is
//     stored k-major in shared memory, the rhs slab row-major, both with
//     16-byte global loads; the next slab's loads are issued into
//     registers before the current slab's products, so their latency
//     hides behind the FMAs.
//   * Each thread holds an 8x8 register tile of f32 accumulators (rows
//     ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4, four each), read
//     from shared memory as float4: 16 FMAs per 16-byte shared load.
//   * A tile that starts at or past the real padded length (*n_rows, a
//     device scalar) writes zeros and returns: the wrapper pads for the
//     worst case (T + E * 128 rows). (Given tile_rows, the wrapper zeroes
//     the rows past a tile's real count afterwards; prefill passes none.
//     A per-row test in this kernel's epilogue made it spill more and run
//     a prefill layer ~5 % slower: PERF.md, PR 18.)
//   * The f32 output is written once, as float4.
//
// The decode kernel (a decode step: 32 tokens x top-8 = 256 rows over 32
// experts, ~8 real rows a tile and never more than 32): the tiled kernel
// multiplies all 128 rows of every used expert's tile, 16x the real work,
// and its 136 blocks of 16.8 M FMAs each run about one an SM; the step is
// bound by the weight bytes instead. So this kernel (further down) gives
// each (tile, 64-column slab) a block that streams the expert's weight
// slab once through a cp.async ring and multiplies only the tile's real
// rows (tile_rows), with the same sequential fmaf chain over k as the
// tiled kernel: its outputs equal the tiled kernel's bitwise. A tile of
// more than 32 real rows takes a pass per 32 rows, each streaming the
// slab again, which is why prefill keeps the tiled kernel.
// Not yet: wgmma/TMA and a bf16/TF32 product (it changes the numbers).

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;          // rows per m-tile (the reference's M_TILE)
constexpr int kBN = 128;          // columns per block
constexpr int kBK = 32;           // K slab staged in shared memory
constexpr int kThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each
constexpr int kAStride = kBM + 4; // k-major lhs slab row (16-byte aligned)

// lhs dtype codes (repro_torch.kernels.moe_group_matmul._LHS_CODE)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The lhs slab [128 rows, 32 k] of one K step, held in registers between
// its global load and its store (k-major, as f32) into shared memory.
template <int LT> struct ASlab;

template <> struct ASlab<kF32> {
  using T = float;
  float4 v[4];   // 1,024 float4 per slab, 4 per thread
  __device__ __forceinline__ void load(const float* lhs, long long row0,
                                       int K, int k0, int t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 3, c = (idx & 7) << 2;
      v[i] = __ldg(reinterpret_cast<const float4*>(
          lhs + (row0 + r) * K + k0 + c));
    }
  }
  __device__ __forceinline__ void store(float (*As)[kAStride], int t) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 3, c = (idx & 7) << 2;
      As[c][r] = v[i].x;
      As[c + 1][r] = v[i].y;
      As[c + 2][r] = v[i].z;
      As[c + 3][r] = v[i].w;
    }
  }
};

template <> struct ASlab<kBF16> {
  using T = unsigned short;   // bf16 bits
  uint4 v[2];    // 512 uint4 (8 bf16 each) per slab, 2 per thread
  __device__ __forceinline__ void load(const unsigned short* lhs,
                                       long long row0, int K, int k0,
                                       int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 2, c = (idx & 3) << 3;
      v[i] = __ldg(reinterpret_cast<const uint4*>(
          lhs + (row0 + r) * K + k0 + c));
    }
  }
  __device__ __forceinline__ void store(float (*As)[kAStride], int t) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 2, c = (idx & 3) << 3;
      As[c][r] = bf16_lo(v[i].x);
      As[c + 1][r] = bf16_hi(v[i].x);
      As[c + 2][r] = bf16_lo(v[i].y);
      As[c + 3][r] = bf16_hi(v[i].y);
      As[c + 4][r] = bf16_lo(v[i].z);
      As[c + 5][r] = bf16_hi(v[i].z);
      As[c + 6][r] = bf16_lo(v[i].w);
      As[c + 7][r] = bf16_hi(v[i].w);
    }
  }
};

// The rhs slab [32 k, 128 columns] of one K step.
struct BSlab {
  float4 v[4];   // 1,024 float4 per slab, 4 per thread
  __device__ __forceinline__ void load(const float* w, int N, int col0,
                                       int k0, int t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 5, c = (idx & 31) << 2;
      v[i] = __ldg(reinterpret_cast<const float4*>(
          w + (long long)(k0 + r) * N + col0 + c));
    }
  }
  __device__ __forceinline__ void store(float (*Bs)[kBN], int t) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + i * kThreads;
      const int r = idx >> 5, c = (idx & 31) << 2;
      *reinterpret_cast<float4*>(&Bs[r][c]) = v[i];
    }
  }
};

// Four consecutive f32 outputs of one row (16-byte aligned).
__device__ __forceinline__ void put4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int LT>
__global__ void __launch_bounds__(kThreads, 2)
moe_group_matmul_kernel(const typename ASlab<LT>::T* __restrict__ lhs,
                        const float* __restrict__ rhs,
                        const int* __restrict__ tile_expert,
                        const int* __restrict__ n_rows,
                        float* __restrict__ out, int K, int N, int E) {
  __shared__ __align__(16) float As[kBK][kAStride];
  __shared__ __align__(16) float Bs[kBK][kBN];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int n_tiles = N / kBN;
  const int m_tile = blockIdx.x / n_tiles;
  const int col0 = (blockIdx.x % n_tiles) * kBN;
  const long long row0 = (long long)m_tile * kBM;
  // the thread's 8 rows and 8 columns, as two runs of 4
  const int rA = ty * 4, rB = 64 + ty * 4;
  const int cA = tx * 4, cB = 64 + tx * 4;
  float* o = out + row0 * N + col0;

  if (n_rows != nullptr && row0 >= (long long)__ldg(n_rows)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = (i < 4 ? rA + i : rB + i - 4);
      put4(o + r * N + cA, 0.f, 0.f, 0.f, 0.f);
      put4(o + r * N + cB, 0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  int e = __ldg(tile_expert + m_tile);
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  const float* w = rhs + (long long)e * K * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  ASlab<LT> a;
  BSlab b;
  a.load(lhs, row0, K, 0, t);
  b.load(w, N, col0, 0, t);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    a.store(As, t);
    b.store(Bs, t);
    __syncthreads();
    if (k0 + kBK < K) {       // the next slab's loads fly under the FMAs
      a.load(lhs, row0, K, k0 + kBK, t);
      b.load(w, N, col0, k0 + kBK, t);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][rA]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][rB]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][cA]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][cB]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = (i < 4 ? rA + i : rB + i - 4);
    put4(o + r * N + cA, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    put4(o + r * N + cB, acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <int LT>
void launch(const void* lhs, const float* rhs, const int* tile_expert,
            const int* n_rows, float* out, int t_pad, int K, int N, int E,
            cudaStream_t s) {
  // one 1-D grid, the n-tiles of an m-tile adjacent (as launched before):
  // up to 2^31 - 1 blocks, so no 65,535 cap on the m-tiles
  const dim3 grid((unsigned)((long long)(t_pad / kBM) * (N / kBN)));
  moe_group_matmul_kernel<LT><<<grid, kThreads, 0, s>>>(
      static_cast<const typename ASlab<LT>::T*>(lhs), rhs, tile_expert,
      n_rows, out, K, N, E);
}

// ---------------------------------------------------------------------
// The decode kernel: the same function when a tile holds few real rows.
//
// One block per (m-tile, 64-column slab); it streams the tile's expert's
// weight slab [K, 64] once per 32 real rows (once at decode) through a
// cp.async ring of kDStages stages of kDK k-rows (16-byte copies, 256
// contiguous bytes per k-row; the ring keeps ~7 stages, 56 KB of weights
// and the matching lhs rows, in flight per block without holding
// registers; two blocks fit an SM). Thread t owns the four columns
// 4 * (t % 16) .. + 3 and the rows t / 16 + 8 * i, i < 4, of the pass: a
// real row is a register tile
// of 4 sums, a row past the tile's real count is never multiplied. Each
// sum is the same sequential fmaf chain over k = 0 .. K - 1 from zero as
// the tiled kernel's (lhs taken to f32 exactly), so the two kernels'
// outputs are bitwise equal. Rows past the count, and tiles at or past
// n_rows, are written as zeros.
constexpr int kDN = 64;            // columns per block
constexpr int kDK = 32;            // k-rows per stage
constexpr int kDStages = 8;         // ~7 stages (56 KB of weights) in flight
constexpr int kDThreads = 128;
constexpr int kDRows = 32;         // rows per pass: 8 row slots x 4
constexpr int kDPitch = kDK * 4 + 16;   // lhs stage row pitch, bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kDStageW = kDK * kDN * 4;          // weight bytes a stage
constexpr int kDStageA = kDRows * kDPitch;       // lhs bytes a stage
constexpr int kDSmem = kDStages * (kDStageW + kDStageA);

// four consecutive k of one lhs row from a stage, as f32
template <int LT> struct ARow;
template <> struct ARow<kF32> {
  using T = float;
  static constexpr int kBytes = 4;
  __device__ __forceinline__ static float4 get(const char* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct ARow<kBF16> {
  using T = unsigned short;
  static constexpr int kBytes = 2;
  __device__ __forceinline__ static float4 get(const char* p) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                       bf16_hi(v.y));
  }
};

template <int LT>
__global__ void __launch_bounds__(kDThreads)
moe_group_matmul_decode_kernel(const typename ARow<LT>::T* __restrict__ lhs,
                               const float* __restrict__ rhs,
                               const int* __restrict__ tile_expert,
                               const int* __restrict__ tile_rows,
                               const int* __restrict__ n_rows,
                               float* __restrict__ out, int K, int N, int E) {
  extern __shared__ __align__(16) char smem[];
  constexpr int kAB = ARow<LT>::kBytes;
  constexpr int kAChunks = kDK * kAB / 16;        // 16-byte pieces a row
  const int t = threadIdx.x;
  const int cq = t & 15, rs = t >> 4;             // column quad, row slot
  const int n_slabs = N / kDN;
  const int m_tile = blockIdx.x / n_slabs;
  const int col0 = (blockIdx.x % n_slabs) * kDN;
  const long long row0 = (long long)m_tile * kBM;
  float* o = out + row0 * N + col0 + 4 * cq;

  int live = __ldg(tile_rows + m_tile);
  live = live < 0 ? 0 : (live > kBM ? kBM : live);
  if (n_rows != nullptr && row0 >= (long long)__ldg(n_rows)) live = 0;
  int e = __ldg(tile_expert + m_tile);
  e = e < 0 ? 0 : (e >= E ? E - 1 : e);
  const float* w = rhs + (long long)e * K * N + col0;
  const typename ARow<LT>::T* a = lhs + row0 * K;
  const int nk = K / kDK;

  for (int p0 = 0; p0 < live; p0 += kDRows) {
    const int rows = min(kDRows, live - p0);
    auto load = [&](int kt) {
      char* st = smem + (kt % kDStages) * (kDStageW + kDStageA);
      const int k0 = kt * kDK;
#pragma unroll
      for (int i = 0; i < kDStageW / 16 / kDThreads; ++i) {
        const int c = t + i * kDThreads;          // 16 pieces a k-row
        cp_async16(st + c * 16, w + (long long)(k0 + (c >> 4)) * N
                                    + (c & 15) * 4);
      }
      for (int c = t; c < rows * kAChunks; c += kDThreads) {
        const int r = c / kAChunks, q = c % kAChunks;
        cp_async16(st + kDStageW + r * kDPitch + q * 16,
                   a + (long long)(p0 + r) * K + k0 + q * (16 / kAB));
      }
    };
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kDStages - 1; ++kt) {
      if (kt < nk) load(kt);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kDStages - 2>();
      __syncthreads();                 // stage kt landed; kt - 1 is free
      if (kt + kDStages - 1 < nk) load(kt + kDStages - 1);
      cp_async_commit();
      const char* st = smem + (kt % kDStages) * (kDStageW + kDStageA);
      const float* ws = reinterpret_cast<const float*>(st) + 4 * cq;
      const char* as = st + kDStageW;
#pragma unroll
      for (int kk = 0; kk < kDK; kk += 4) {
        float4 wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wv[u] = *reinterpret_cast<const float4*>(ws + (kk + u) * kDN);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rs + 8 * i;
          if (r >= rows) continue;
          const float4 av = ARow<LT>::get(as + r * kDPitch + kk * kAB);
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {   // k ascending, as the tiled kernel
            acc[i][0] = fmaf(ak[u], wv[u].x, acc[i][0]);
            acc[i][1] = fmaf(ak[u], wv[u].y, acc[i][1]);
            acc[i][2] = fmaf(ak[u], wv[u].z, acc[i][2]);
            acc[i][3] = fmaf(ak[u], wv[u].w, acc[i][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                   // the ring is free for the next pass
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rs + 8 * i;
      if (r < rows)
        put4(o + (long long)(p0 + r) * N, acc[i][0], acc[i][1], acc[i][2],
             acc[i][3]);
    }
  }
  for (int r = live + rs; r < kBM; r += 8)
    put4(o + (long long)r * N, 0.f, 0.f, 0.f, 0.f);
}

template <int LT>
int launch_decode(const void* lhs, const float* rhs, const int* tile_expert,
                  const int* tile_rows, const int* n_rows, float* out,
                  int t_pad, int K, int N, int E, cudaStream_t s) {
  // once per device: the shared-memory limit past 48 KB is opted into
  constexpr int kMaxDevices = 64;
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted[dev]) {
    err = cudaFuncSetAttribute(moe_group_matmul_decode_kernel<LT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kDSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  const dim3 grid((unsigned)((long long)(t_pad / kBM) * (N / kDN)));
  moe_group_matmul_decode_kernel<LT><<<grid, kDThreads, kDSmem, s>>>(
      static_cast<const typename ARow<LT>::T*>(lhs), rhs, tile_expert,
      tile_rows, n_rows, out, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9. lhs [t_pad, k] (lhs_dtype 0 = f32, 1 = bf16), rhs f32 [e, k, n],
// tile_expert i32 [t_pad / 128], n_rows i32[1] on the device or null (no
// tile skipped), out f32 [t_pad, n], every pointer 16-byte aligned;
// t_pad % 128 == 0, k % 32 == 0, n % 128 == 0. Returns cudaGetLastError().
int moe_group_matmul_launch(const void* lhs, int lhs_dtype, const float* rhs,
                            const int* tile_expert, const int* n_rows,
                            float* out, int t_pad, int k, int n, int e,
                            void* stream) {
  if (t_pad % kBM || k % kBK || n % kBN || k <= 0 || e <= 0 ||
      (long long)(t_pad / kBM) * (n / kBN) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (t_pad == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lhs_dtype == kF32) {
    launch<kF32>(lhs, rhs, tile_expert, n_rows, out, t_pad, k, n, e, s);
  } else if (lhs_dtype == kBF16) {
    launch<kBF16>(lhs, rhs, tile_expert, n_rows, out, t_pad, k, n, e, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K9's decode kernel: as moe_group_matmul_launch, with tile_rows required.
int moe_group_matmul_decode_launch(const void* lhs, int lhs_dtype,
                                   const float* rhs, const int* tile_expert,
                                   const int* n_rows, const int* tile_rows,
                                   float* out, int t_pad, int k, int n,
                                   int e, void* stream) {
  if (t_pad % kBM || k % kDK || n % kDN || k <= 0 || e <= 0 ||
      tile_rows == nullptr ||
      (long long)(t_pad / kBM) * (n / kDN) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (t_pad == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (lhs_dtype == kF32)
    return launch_decode<kF32>(lhs, rhs, tile_expert, tile_rows, n_rows,
                               out, t_pad, k, n, e, s);
  if (lhs_dtype == kBF16)
    return launch_decode<kBF16>(lhs, rhs, tile_expert, tile_rows, n_rows,
                                out, t_pad, k, n, e, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
