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
//   * prefill (4,096 tokens, 32,768 rows): operations-bound — 103 GFLOP.
//     As f32 FMAs (67 TFLOP/s) that is 1.54 ms against 0.19 ms of bytes.
//     One bf16 or TF32 tensor-core product would round the f32 weights,
//     but an exact split does not: every f32 weight is hi + mid + lo of
//     three bf16 values (3 x 8 significant bits = f32's 24), the rows are
//     bf16 already, and a product of two bf16 values is exact in f32. So
//     three bf16 tensor-core products into one set of f32 accumulators
//     make exactly the reference's products, summed in another order:
//     3 x 103 GFLOP at 989 TFLOP/s is 0.313 ms, the bound of bf16 rows.
// Three kernels compute it; kernels.ops.moe_group_matmul picks one from
// the rows' dtype and the shapes, so the host never syncs:
//
// The tiled kernel (f32 rows in full tiles):
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
// The decode kernel (f32 rows of a decode step: 32 tokens x top-8 = 256
// rows over 32 experts, ~8 real rows a tile and never more than 32; bf16
// rows take the tensor-core kernel, faster at every size): the tiled kernel
// multiplies all 128 rows of every used expert's tile, 16x the real work,
// and its 136 blocks of 16.8 M FMAs each run about one an SM; the step is
// bound by the weight bytes instead. So this kernel (further down) gives
// each (tile, 64-column slab) a block that streams the expert's weight
// slab once through a cp.async ring and multiplies only the tile's real
// rows (tile_rows), with the same sequential fmaf chain over k as the
// tiled kernel: its outputs equal the tiled kernel's bitwise. A tile of
// more than 32 real rows takes a pass per 32 rows, each streaming the
// slab again, which is why prefill does not take it.
//
// The tensor-core kernel (bf16 rows, prefill and decode; further down)
// multiplies on wgmma with the exact three-term split above. It computes
// the transposed product out^T = W^T . lhs^T of a (128-row m-tile,
// 128-column n-tile): wgmma takes its A operand from registers, so each
// consumer thread reads its f32 weights from shared memory and splits them
// there (hi = the f32 pattern with its low 16 bits cleared, r = w - hi,
// mid = r likewise, lo = r - mid, all exact; Inf/NaN -> (w, 0, 0)), while
// the bf16 lhs tile is the B operand as TMA lands it (K-major, 128-byte
// swizzle). One producer warp keeps a ring of 4 stages (64 k: 16 KB of
// lhs and 32 KB of f32 weights) in flight with TMA; two consumer
// warpgroups each own 64 weight columns, 64 f32 accumulators a thread,
// and issue hi, mid and lo as three m64n128k16 products per 16 k, each
// step's fragments built while the step before runs. The A rows g and
// g + 8 of a thread are mapped to neighbouring weight columns, so its
// weights come in 8-byte shared loads and its outputs go out as float2
// (PERF.md: ~10 % over mapping them 8 columns apart). A persistent grid
// (one block an SM) walks the (m-tile, n-tile) items, the ring running on
// across them, so the next item's loads overlap this one's output. The
// split is done in the kernel so the weight stream and the memory stay
// the f32 ones (a bf16 copy of the split weights would add 1.5x their
// bytes, ~7.2 GB for granite); it costs ALU work beside the products
// (PERF.md). f32 rows keep the SIMT kernels: their split would need nine
// products.

#include <cuda.h>           // CUtensorMap (the encoder is fetched at run time)
#include <cuda_runtime.h>

#include <cstdint>

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


// ---------------------------------------------------------------------
// The tensor-core kernel: bf16 rows times f32 weights split into three
// bf16 terms, on wgmma with TMA loads (see the notes at the top).
//
// Block: warps 0-7 are two consumer warpgroups (weight columns 64 * wg ..
// + 63 of the block's 128), warp 8 the producer (one thread issues TMA).
// Per stage s of the ring: the lhs tile [128 rows, 64 k] bf16 (16 KB,
// 128-byte swizzle: the wgmma B operand, K-major) and the weight slab
// [64 k, 128 columns] f32 as four boxes of 32 columns (8 KB each, 128-byte
// swizzle, so a warp's 8-byte fragment reads take just the two wavefronts
// their 256 bytes need). full[s] counts the TMA bytes in; empty[s] the
// eight consumer warps out.
constexpr int kWM = 128;                  // token rows (wgmma N)
constexpr int kWN = 128;                  // weight columns (2 x wgmma M)
constexpr int kWK = 64;                   // k per stage
constexpr int kWBox = 32;                 // weight columns per TMA box
constexpr int kWStages = 4;
constexpr int kWConsumers = 8;            // consumer warps
constexpr int kWThreads = (kWConsumers + 1) * 32;
constexpr int kWStageA = kWM * kWK * 2;   // 16 KB
constexpr int kWBoxBytes = kWK * kWBox * 4;
constexpr int kWStageB = kWK * kWN * 4;   // 32 KB
constexpr int kWStage = kWStageA + kWStageB;
constexpr int kWSmem = kWStages * kWStage + 2 * kWStages * 8 + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// spins on the barrier's phase; a wait that never ends (a fault in the
// pipeline) traps after ~2^30 polls, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// two consecutive f32 outputs (8-byte aligned)
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// wgmma descriptor of a K-major bf16 tile with 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1,024 bytes apart (the layout TMA writes)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16)
         | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the accumulators while a wgmma owns them
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (registers, bf16) . B[16 x 128] (shared, bf16)
// (scale_d 0: d = A . B, the old d ignored)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// Two neighbouring weight elements of a stage's slab: row r (k), columns
// c and c + 1 (c even) of a box, through the 128-byte swizzle (16-byte
// chunk c / 4 XOR r % 8).
__device__ __forceinline__ float2 w_pair(const char* box, int r, int c) {
  return *reinterpret_cast<const float2*>(
      box + r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + ((c & 3) << 2));
}

// The A fragments (hi, mid, lo) of one 16-k step for this thread: A rows
// g and g + 8 of its warp's 16, which this kernel maps to the weight
// columns c and c + 1 (c = 16 w + 2 g, so one 8-byte load reads both),
// k = kk*16 + 2q (+1, +8, +9): the m16n8k16 layout that each warp of
// wgmma's A uses (two bf16 a register, the lower k in the low half).
//
// The split, per weight w: hi = w with the low 16 bits of its pattern
// cleared; r = w - hi (exact); mid = the high half of r's pattern (r with
// its low 16 bits cleared); lo = r - mid (exact: at most 8 significant
// bits, so its high half is all of it when |w| >= 2^-100). Non-finite w
// gives a NaN r: then r is taken as 0 (mid = lo = 0), and a NaN w keeps
// a NaN hi ((w, 0, 0), as kernels.moe_group_matmul.split_bf16x3).
__device__ __forceinline__ void a_fragments(uint32_t (&a)[3][4],
                                            const char* box, int c, int q,
                                            int kk) {
  const int r0 = kk * 16 + 2 * q;
  const float2 x = w_pair(box, r0, c), y = w_pair(box, r0 + 1, c);
  const float2 z = w_pair(box, r0 + 8, c), u = w_pair(box, r0 + 9, c);
  // register j of the fragment pairs v[2j] (lower k) with v[2j + 1]
  const float v[8] = {x.x, y.x, x.y, y.y, z.x, u.x, z.y, u.y};
  uint32_t hb[8], rb[8], lb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t b = __float_as_uint(v[i]);
    float r = __fsub_rn(v[i], __uint_as_float(b & 0xffff0000u));
    const bool bad = r != r;                // w is Inf or NaN
    r = bad ? 0.f : r;
    hb[i] = v[i] != v[i] ? 0x7fc00000u : b;
    rb[i] = __float_as_uint(r);
    lb[i] = __float_as_uint(
        __fsub_rn(r, __uint_as_float(rb[i] & 0xffff0000u)));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {               // the high halves, paired
    a[0][j] = __byte_perm(hb[2 * j], hb[2 * j + 1], 0x7632);
    a[1][j] = __byte_perm(rb[2 * j], rb[2 * j + 1], 0x7632);
    a[2][j] = __byte_perm(lb[2 * j], lb[2 * j + 1], 0x7632);
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
moe_group_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_lhs,
                              const __grid_constant__ CUtensorMap map_w,
                              const int* __restrict__ tile_expert,
                              const int* __restrict__ n_rows,
                              float* __restrict__ out, int K, int N, int E,
                              int n_work) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStage);
  uint64_t* empty = full + kWStages;

  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int n_tiles = N / kWN;
  const int nk = K / kWK;
  const long long live_rows =
      n_rows != nullptr ? (long long)__ldg(n_rows) : (1LL << 62);
  // consumer geometry: warpgroup wg, warp w in it, lane (g, q)
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, q = lane & 3;
  const int c = 16 * w + 2 * g;   // weight columns c, c + 1 of the 64

  if (t == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A persistent block walks the work items (m-tile, n-tile) blockIdx.x,
  // + gridDim.x, ... (the n-tiles of an m-tile adjacent). The ring and its
  // phases run on across items, so the producer loads the next item's
  // stages while the consumers write this one's output.
  if (warp == kWConsumers) {                // the producer
    if (lane == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
        const int m_tile = item / n_tiles;
        const long long row0 = (long long)m_tile * kWM;
        if (row0 >= live_rows) continue;
        const int col0 = (item % n_tiles) * kWN;
        int e = __ldg(tile_expert + m_tile);
        e = e < 0 ? 0 : (e >= E ? E - 1 : e);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % kWStages;
          if (it >= kWStages)
            mbar_wait(&empty[s], ((it / kWStages) - 1) & 1);
          char* st = smem + s * kWStage;
          mbar_expect_tx(&full[s], kWStage);
          tma_load_2d(st, &map_lhs, &full[s], kt * kWK, (int)row0);
#pragma unroll
          for (int b = 0; b < kWN / kWBox; ++b)
            tma_load_2d(st + kWStageA + b * kWBoxBytes, &map_w, &full[s],
                        col0 + b * kWBox, e * K + kt * kWK);
        }
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);         // only wgmma and the epilogue touch them below
  uint32_t a[2][3][4];
  // the box that holds this thread's columns c and c + 1
  const int box = 2 * wg + (c >> 5), cb = c & 31;
  int it = 0;
  for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
    const int m_tile = item / n_tiles;
    const long long row0 = (long long)m_tile * kWM;
    float* o = out + row0 * N + (item % n_tiles) * kWN + 64 * wg;
    if (row0 >= live_rows) {                // past the real rows: zeros
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const long long n = 8 * i + 2 * q;
        put2(o + n * N + c, 0.f, 0.f);
        put2(o + (n + 1) * N + c, 0.f, 0.f);
      }
      continue;
    }
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kWStages;
      mbar_wait(&full[s], (it / kWStages) & 1);
      const char* st = smem + s * kWStage;
      const char* wb = st + kWStageA + box * kWBoxBytes;
      const uint64_t desc = desc_sw128(st);
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        uint32_t (&ak)[3][4] = a[kk & 1];
        a_fragments(ak, wb, cb, q, kk);
        wgmma_fence();
        // 16 k = 32 bytes further along the swizzled rows; the item's
        // first product overwrites the accumulators (scale-d 0)
        wgmma_m64n128k16_rs(acc, ak[0], desc + 2 * kk, kt + kk > 0);
        wgmma_m64n128k16_rs(acc, ak[1], desc + 2 * kk, 1);
        wgmma_m64n128k16_rs(acc, ak[2], desc + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait<1>();                    // the step before is done
        if (kk == 0 && it > 0 && lane == 0)
          mbar_arrive(&empty[(it - 1) % kWStages]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // acc[4i + j]: A row g (j < 2) or g + 8, so weight column c or c + 1,
    // and token row 8i + 2q (+1 for odd j) — the wgmma accumulator
    // layout of the transposed product
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long n = 8 * i + 2 * q;
      put2(o + n * N + c, acc[4 * i], acc[4 * i + 2]);
      put2(o + (n + 1) * N + c, acc[4 * i + 1], acc[4 * i + 3]);
    }
    fence_acc(acc);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 2-D row-major [rows, cols] map with a [box_rows, box_cols] box and
// 128-byte swizzle (box_cols * element bytes == 128)
int tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType dt,
                  int elem_bytes, long long rows, long long cols,
                  int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(map, dt, 2, const_cast<void*>(base), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_wgmma(const void* lhs, const float* rhs, const int* tile_expert,
                 const int* n_rows, float* out, int t_pad, int K, int N,
                 int E, cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted[dev]) {
    err = cudaFuncSetAttribute(moe_group_matmul_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  CUtensorMap map_lhs, map_w;
  int rc = tensor_map_2d(&map_lhs, lhs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         t_pad, K, kWM, kWK);
  if (rc) return rc;
  rc = tensor_map_2d(&map_w, rhs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                     (long long)E * K, N, kWK, kWBox);
  if (rc) return rc;
  static int sms[kMaxDevices] = {};
  int n_sm = dev < kMaxDevices ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) sms[dev] = n_sm;
  }
  const int n_work = (t_pad / kWM) * (N / kWN);
  moe_group_matmul_wgmma_kernel<<<n_work < n_sm ? n_work : n_sm, kWThreads,
                                  kWSmem, s>>>(map_lhs, map_w, tile_expert,
                                               n_rows, out, K, N, E, n_work);
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

// K9's tensor-core kernel: as moe_group_matmul_launch for bf16 lhs
// (lhs_dtype 1) only; k % 64 == 0, n % 128 == 0, (E * k) < 2^32.
int moe_group_matmul_wgmma_launch(const void* lhs, int lhs_dtype,
                                  const float* rhs, const int* tile_expert,
                                  const int* n_rows, float* out, int t_pad,
                                  int k, int n, int e, void* stream) {
  if (lhs_dtype != kBF16 || t_pad % kWM || k % kWK || n % kWN || k <= 0 ||
      e <= 0 || (long long)e * k > 4294967295LL ||
      (long long)(t_pad / kWM) * (n / kWN) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (t_pad == 0 || n == 0) return 0;
  return launch_wgmma(lhs, rhs, tile_expert, n_rows, out, t_pad, k, n, e,
                      (cudaStream_t)stream);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
