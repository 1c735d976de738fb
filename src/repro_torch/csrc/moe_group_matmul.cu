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
// Design (simple and right first):
//   * One 256-thread block per (128-row m-tile, 128-column n-tile), on a
//     1-D grid (up to 2^31 - 1 blocks, so T_pad has no practical cap) with
//     the n-tiles of one m-tile adjacent. The m-tiles past the real length
//     then start last: at decode (136 blocks on 132 SMs) the blocks that
//     share an SM are ones that exit at once (the m-tiles on grid.x and
//     the n-tiles on grid.y slowed a decode layer; PERF.md, PR 16). The
//     block reads its own tile_expert entry (no scalar prefetch) and
//     clamps it to [0, E), as the reference's gathers clamp.
//   * The K loop goes in slabs of 32: the lhs slab (converted to f32) is
//     stored k-major in shared memory, the rhs slab row-major, both with
//     16-byte global loads; the next slab's loads are issued into
//     registers before the current slab's products, so their latency
//     hides behind the FMAs.
//   * Each thread holds an 8x8 register tile of f32 accumulators (rows
//     ty*4 and 64 + ty*4, columns tx*4 and 64 + tx*4, four each), read
//     from shared memory as float4: 16 FMAs per 16-byte shared load.
//   * A tile that starts at or past the real padded length (*n_rows, a
//     device scalar, so the host never syncs) writes zeros and returns:
//     the wrapper pads for the worst case (T + E * 128 rows).
//   * The f32 output is written once, as float4.
// Not yet: wgmma/TMA, a bf16/TF32 product (it changes the numbers), and
// skipping the zero rows inside a group's last tile (decode pays 128 rows
// per used expert for ~8 real ones). Later, measured PRs; see PERF.md.

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

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
