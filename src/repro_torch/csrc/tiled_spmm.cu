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
// plus X and Y; the tile format streams 4 KiB (f32) per stored tile,
// 100-1000x more at fill ratios of 1e-3..1e-2. K6/K7 read that stream
// (tile bytes over 3.35 TB/s is what they can approach). K5 reads a
// zero-free copy of it instead (below): 4 B per tile of offsets, 2 B of
// packed position and 4 B (f32) or 2 B (bf16) of value per stored
// nonzero, with the tile indices, X and Y, ~45 MB at road_like --scale 8
// against the 1.67 GB tile stream. So K5 is bound by latency, not bytes:
// the design keeps many independent loads in flight per warp. The
// arithmetic the function needs is 2 * nnz * k flops, far below either
// stream time at the f32 FMA rate; the dense tile math (2 * 1024 * k per
// tile) would be ~80x more at road_like's ~13 nonzeros a tile.
//
// Design:
//   * Order and reduction. The TPU grid runs in order and every step adds
//     into one y. Here a warp (K5: a chunk of 32 tiles) or a block (K6/K7:
//     chunks of 8 tiles) takes contiguous runs of the stored stream, so
//     the visit order of the paper algorithm that ordered the tiles stays
//     the stream order within a run.
//     Consecutive tiles of one tile-row (a row-ordered stream) are summed
//     on chip (K5: shared memory, K6/K7: registers); when the tile-row
//     changes the sums are added into Y with f32 atomic adds (RED) into a
//     zeroed Y, only for rows with a stored nonzero. So the number of
//     atomics follows the stream's y-window switches, and the order of
//     the adds, and the last bits, vary from run to run.
//   * K5 reads the compact operand: the tile stream without its stored
//     zeros, in the same visit order (built once per TiledSparse by the
//     wrapper, see the K5 section). One warp per chunk of 32 tiles (a
//     chunk with more than 1,024 entries, as in mawi_like's dense row, is
//     split over several warps): lane i loads tile i's row, column and
//     X-block flag (coalesced), and the chunk's nonzero range; then every
//     lane loads 8 consecutive entries (one 16-byte load of positions,
//     one or two of values) and their 8 x values at once, 256 entries a
//     pass, so a chunk costs about three dependent load latencies, not
//     one per tile.
//     Each entry's tile (its top position bits) gives its run and column
//     by shuffle from the lane that holds the tile. A lane sums its
//     consecutive entries of one (run, row) and adds them to that slot in
//     shared memory; at the chunk's end each nonzero slot is added into Y
//     once. Runs of one tile row inside a chunk share their slots.
//     Trial builds on the H100 (PERF.md) were no faster with a
//     persistent grid that loads the next chunk's entries ahead, chunks
//     of 16 tiles, slots per (tile, row) written without atomics where no
//     other lane shares them, or fewer registers for more warps an SM.
//   * K6/K7 work on the stored nonzeros, not on the dense tile: at
//     road_like's ~13 nonzeros of 1,024 a dense 8x128 product spends ~99 %
//     of its FMAs and X loads on stored zeros. A block is 2 warps; warp w
//     owns tile rows 4w .. 4w+3 of every tile the block takes. For each of
//     its rows, lane l reads columns 4l .. 4l+3, three ballots of the
//     lanes' nonzero counts give each lane its place, and the warp writes
//     the row's nonzero columns to the row's list in shared memory. The
//     lanes then walk the lists: a pass covers up to 32 output columns,
//     lane l takes column l % cp (cp = 32, or k rounded up to a power of
//     two when k < 32), and the 32 / cp lane shares take every (32/cp)-th
//     entry, so an entry costs one coalesced X row segment and one FMA per
//     column. A walk pass takes entries of all four rows at once (up to 8
//     X loads a lane in flight); a tile with a long row (a dense row)
//     walks row by row. The f32 sums of the four rows stay in registers
//     over consecutive tiles of one tile-row (for k <= 128); at the flush
//     the shares are summed with shuffles. A wider k walks the lists once
//     per 128 columns and adds each tile's sums at once.
//   * Non-finite X. The dense tile product carries a NaN or Inf of X
//     through a stored zero (0 * Inf = NaN), and so do the reference and
//     the plain version. Skipping a zero is exact only where the 128-row X
//     block, rounded to the tile dtype, is finite, so a pre-pass
//     (x_block_finite_kernel, X read once; K5's own spmv_prepass_kernel
//     takes a warp per X block and also zeroes Y) writes one flag per X
//     block on the device, with no host sync, and a tile over a non-finite
//     block also walks its zero positions (K5: in its dense tile, which
//     stays stored). The answer then equals the dense product's, NaN and
//     Inf included.
//   * K6/K7's stream. The grid is persistent: the card's SMs times the
//     blocks that fit on one. The stream is dealt in chunks of 8 consecutive
//     tiles, round-robin over the blocks: the visit order holds within a
//     chunk, the blocks move through the stream together (the X and Y rows
//     they touch stay in L2), and a long tile-row (mawi_like's dense row,
//     2,048 tiles) is spread over many blocks. Each warp streams its four
//     rows of the block's tiles (2 KiB f32, 1 KiB bf16) and the tiles' row
//     and column indices through a ring of 3 (f32) or 4 (bf16) slots in
//     shared memory with cp.async, so the next tiles are in flight while
//     one is used. The warps never wait for each other (no
//     __syncthreads). Trial builds on the H100 (PERF.md, PR 16) ran slower
//     with one, two or eight rows per warp, a fourth ring slot or chunks
//     of 32 tiles: fewer warps fit on an SM, each did more fixed work per
//     row, or the blocks drifted apart in the stream.
//   * The stream is read once per launch whatever K6's column tile kt is:
//     every column of a staged row is done by the warp that holds it, so
//     the entry point does not take kt.
//   * X rows past n (the ragged last tile column) are read as zero; Y is
//     allocated with the padded row count m_pad = 8 * ceil(m / 8).
// FP32 FMA, no tensor cores: they would round X or the tile, and at ~13
// nonzeros a tile they would not pay.

#include <cuda_runtime.h>

#include <algorithm>

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
  // and XLA's convert do); v is not a NaN (x_in)
  static __device__ __forceinline__ float round_x(float v) {
    unsigned u = __float_as_uint(v);
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
  }
};

// ------------------------------------------------------------ K6 / K7 ----
constexpr int kRows = 4;                         // tile rows a warp owns
constexpr int kSpmmWarps = kTileR / kRows;       // warps per block
constexpr int kChunk = 8;                        // consecutive tiles per deal
constexpr int kPassCols = 32;                    // output columns per pass
constexpr int kLoadsInFlight = 8;                // X loads per lane per pass
constexpr int kFiniteThreads = 256;              // the X pre-pass block

// ring slots per warp: kRows rows of a tile each (2 KiB f32, 1 KiB bf16)
template <int DT> struct Ring { static constexpr int kStages = 4; };
template <> struct Ring<kF32> { static constexpr int kStages = 3; };

// Asynchronous 16-byte copy global -> shared (cp.async; bypasses L1: the
// tile stream is read once), and the 4-byte form for the tile indices.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive tile values (16- or 8-byte aligned) from the ring, and
// one
__device__ __forceinline__ float4 stage4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 stage4(const unsigned short* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}
__device__ __forceinline__ float stage1(const float* p) { return *p; }
__device__ __forceinline__ float stage1(const unsigned short* p) {
  return __uint_as_float((unsigned)*p << 16);
}

// x rounded to the tile dtype; a NaN stays a NaN (K5's rounding assumes a
// finite x, and a NaN's payload could carry into the sign)
template <int DT> __device__ __forceinline__ float x_in(float v) {
  return v == v ? Tile<DT>::round_x(v) : v;
}

// finite[b] = 1 when every value of X block b (rows b*128 : +128, all k
// columns, contiguous in X [n, k]) is finite after the rounding to the
// tile dtype, else 0. One block per X block.
template <int DT>
__global__ void __launch_bounds__(kFiniteThreads)
x_block_finite_kernel(const float* __restrict__ x, int* __restrict__ finite,
                      int n, int k) {
  const long long r0 = (long long)blockIdx.x * kTileC;
  const long long e0 = r0 * k;                   // a multiple of 128
  const long long e1 = min(r0 + kTileC, (long long)n) * k;
  const long long ev = e0 + ((e1 - e0) & ~3LL);
  int ok = 1;
  for (long long e = e0 + 4LL * threadIdx.x; e < ev;
       e += 4LL * kFiniteThreads) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x + e));
    ok &= isfinite(x_in<DT>(v.x)) & isfinite(x_in<DT>(v.y)) &
          isfinite(x_in<DT>(v.z)) & isfinite(x_in<DT>(v.w));
  }
  for (long long e = ev + threadIdx.x; e < e1; e += kFiniteThreads)
    ok &= isfinite(x_in<DT>(x[e]));
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) finite[blockIdx.x] = ok ? 1 : 0;
}

// A lane's output column in each pass of one sweep (columns g : +NP*32).
template <int NP> struct Cols {
  int col[NP];
  bool on[NP];      // col < k
};

template <int NP>
__device__ __forceinline__ Cols<NP> cols_of(int g, int jl, int k) {
  Cols<NP> cs;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    cs.col[q] = g + q * kPassCols + jl;
    cs.on[q] = cs.col[q] < k;
  }
  return cs;
}

// One pass over the warp's rows of a staged tile: entries e0, e0 +
// stride, ... (U of them) of every row's list, or, for ZEROS, the
// positions e0, ... whose stored value is zero. The tile values and every
// X load first, then the FMAs into the row sums acc[row]. Entries past a
// row's count add 0 * 0.
template <int DT, int NP, int U, bool ZEROS>
__device__ __forceinline__ void walk_pass(
    const typename Tile<DT>::T* tile, const unsigned short* lst,
    const int (&cnt)[kRows], int e0, int stride, const float* xb,
    int rows_left, int k, const Cols<NP>& cs, float (&acc)[kRows][NP]) {
  float a[kRows][U], xv[kRows][U][NP];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * stride;
      bool ok = e < (ZEROS ? kTileC : cnt[rr]);
      const int col = !ok ? 0 : (ZEROS ? e : (int)lst[rr * kTileC + e]);
      a[rr][u] = ok ? stage1(tile + rr * kTileC + col) : 0.f;
      if (ZEROS) ok = ok && a[rr][u] == 0.f;
      ok = ok && col < rows_left;                // X rows past n are zero
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        xv[rr][u][q] = 0.f;
        if (ok && cs.on[q]) xv[rr][u][q] = __ldg(xb + col * k + cs.col[q]);
      }
    }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int q = 0; q < NP; ++q)
        acc[rr][q] = fmaf(a[rr][u], x_in<DT>(xv[rr][u][q]), acc[rr][q]);
}

// U entries e0, e0 + stride, ... of row rr's list into acc (its sums).
template <int DT, int NP, int U>
__device__ __forceinline__ void walk_row(
    const typename Tile<DT>::T* tile, const unsigned short* lst, int rr,
    int cnt, int e0, int stride, const float* xb, int rows_left, int k,
    const Cols<NP>& cs, float (&acc)[NP]) {
  float a[U], xv[U][NP];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = e0 + u * stride;
    const bool ok = e < cnt;
    const int col = ok ? (int)lst[rr * kTileC + e] : 0;
    a[u] = ok ? stage1(tile + rr * kTileC + col) : 0.f;
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      xv[u][q] = 0.f;
      if (ok && col < rows_left && cs.on[q])
        xv[u][q] = __ldg(xb + col * k + cs.col[q]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int q = 0; q < NP; ++q)
      acc[q] = fmaf(a[u], x_in<DT>(xv[u][q]), acc[q]);
}

// Every entry of the lane's share (share, share + shares, ...), in passes
// of about kLoadsInFlight X loads a lane over all rows at once; `most` is
// the longest row list. A tile with a long row (a dense row) walks row by
// row instead, so its passes load only that row's entries.
template <int DT, int NP, bool ZEROS>
__device__ __forceinline__ void walk(
    const typename Tile<DT>::T* tile, const unsigned short* lst,
    const int (&cnt)[kRows], int most, int share, int shares,
    const float* xb, int rows_left, int k, const Cols<NP>& cs,
    float (&acc)[kRows][NP]) {
  constexpr int U = kLoadsInFlight / (kRows * NP) > 1
                        ? kLoadsInFlight / (kRows * NP) : 1;
  constexpr int UR = kLoadsInFlight / NP;
  if (!ZEROS && most > 2 * U * shares) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      for (int e0 = share; e0 < cnt[rr]; e0 += UR * shares)
        walk_row<DT, NP, UR>(tile, lst, rr, cnt[rr], e0, shares, xb,
                             rows_left, k, cs, acc[rr]);
    return;
  }
  for (int e0 = share; e0 < most; e0 += U * shares)
    walk_pass<DT, NP, U, ZEROS>(tile, lst, cnt, e0, shares, xb, rows_left,
                                k, cs, acc);
}

// Add the sums of the warp's rows in `rows` (a warp-uniform bit mask) into
// Y rows y0 + row, summed over the lane shares first; every sum restarts
// from zero.
template <int NP>
__device__ __forceinline__ void flush(float (&acc)[kRows][NP], unsigned rows,
                                      float* __restrict__ y, long long y0,
                                      int k, const Cols<NP>& cs, int cp,
                                      bool lead) {
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    if (rows >> rr & 1u) {
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        float v = acc[rr][q];
        for (int off = cp; off < 32; off <<= 1)
          v += __shfl_xor_sync(kFull, v, off);
        if (cs.on[q] && lead) atomicAdd(y + (y0 + rr) * k + cs.col[q], v);
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[rr][q] = 0.f;
  }
}

// kSpmmWarps warps per block, warp w owning tile rows w * kRows .. +kRows
// of every tile the block takes; the warps never wait for each other.
template <int DT, int NP>
__global__ void __launch_bounds__(kSpmmWarps * 32)
tiled_spmm_kernel(const typename Tile<DT>::T* __restrict__ tiles,
                  const int* __restrict__ tile_rows,
                  const int* __restrict__ tile_cols,
                  const float* __restrict__ x,
                  const int* __restrict__ finite, float* __restrict__ y,
                  int num_tiles, int n, int k) {
  using T = typename Tile<DT>::T;
  constexpr int S = Ring<DT>::kStages;
  constexpr int kElems = kRows * kTileC;         // a warp's part of a tile
  constexpr int kCopies = kElems * (int)sizeof(T) / (16 * 32);
  static_assert(kCopies >= 1, "a lane copies 16-byte pieces");
  __shared__ __align__(16) T ring[kSpmmWarps][S][kElems];
  __shared__ __align__(8) int head[kSpmmWarps][S][2];  // tile row, column
  // per row, the columns of its nonzeros
  __shared__ unsigned short lists[kSpmmWarps][kElems];

  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int G = gridDim.x;
  const int b = blockIdx.x;
  const int chunks = (int)(((long long)num_tiles + kChunk - 1) / kChunk);
  if (b >= chunks) return;                       // the whole block
  // this block's chunks are b, b + G, ...; P tiles in all
  const int mine = (chunks - 1 - b) / G + 1;
  const int last = b + (mine - 1) * G;
  const int P = (mine - 1) * kChunk + min(kChunk, num_tiles - last * kChunk);

  // copy the warp's rows of local tile p, with the tile's indices, into
  // ring slot s; one commit group per p (empty past the end, so the group
  // count is fixed)
  auto issue = [&](int p, int s) {
    if (p < P) {
      const long long t =
          (long long)(b + (p / kChunk) * G) * kChunk + p % kChunk;
      const char* src = reinterpret_cast<const char*>(
          tiles + t * kTileElems + wi * kElems);
      char* dst = reinterpret_cast<char*>(ring[wi][s]);
#pragma unroll
      for (int j = 0; j < kCopies; ++j)
        cp_async16(dst + (j * 32 + lane) * 16, src + (j * 32 + lane) * 16);
      if (lane == 0) {
        cp_async4(&head[wi][s][0], tile_rows + t);
        cp_async4(&head[wi][s][1], tile_cols + t);
      }
    }
    cp_async_commit();
  };

  // passes: k <= 32 takes one pass of cp = k rounded up to a power of two
  // columns and 32 / cp lane shares; a wider k takes 32-column passes
  int cp = kPassCols;
  if (NP == 1)
    for (cp = 1; cp < k; cp <<= 1) {}
  const int shares = kPassCols / cp;
  const int share = lane / cp;
  const int jl = lane & (cp - 1);
  const bool lead = share == 0;
  const bool one_sweep = k <= NP * kPassCols;    // sums kept across tiles
  const Cols<NP> cs = cols_of<NP>(0, jl, k);
  const unsigned lt = (1u << lane) - 1u;
  const unsigned all = (1u << kRows) - 1u;
  unsigned short* lst = lists[wi];
  float acc[kRows][NP];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[rr][q] = 0.f;
  int row = -1;
  unsigned dirty = 0;                            // the warp's rows with sums

  for (int p = 0; p < S - 1; ++p) issue(p, p);
  int s = 0, s_next = S - 1;                     // slots of p and p + S - 1
  for (int p = 0; p < P; ++p) {
    issue(p + S - 1, s_next);
    cp_async_wait<S - 1>();                      // local tile p has landed
    __syncwarp();
    const int r = head[wi][s][0];
    const int c = head[wi][s][1];
    const int fin = __ldg(finite + c);           // read after the walk
    const T* tile = ring[wi][s];
    // per row, list the columns of the nonzeros: lane l holds columns
    // 4l .. 4l+3; its place in the row's list is the sum of the counts
    // of the lanes below it, bit by bit over ballots
    int cnt[kRows];
    int most = 0;
    unsigned touched = 0;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float4 v = stage4(tile + rr * kTileC + lane * 4);
      const unsigned nib = (unsigned)(v.x != 0.f) |
                           (unsigned)(v.y != 0.f) << 1 |
                           (unsigned)(v.z != 0.f) << 2 |
                           (unsigned)(v.w != 0.f) << 3;
      const int mine_n = __popc(nib);
      const unsigned b0 = __ballot_sync(kFull, mine_n & 1);
      const unsigned b1 = __ballot_sync(kFull, mine_n & 2);
      const unsigned b2 = __ballot_sync(kFull, mine_n & 4);
      int at = __popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt);
      cnt[rr] = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
      most = max(most, cnt[rr]);
      touched |= cnt[rr] ? 1u << rr : 0u;
      unsigned short* L = lst + rr * kTileC;
      const int c0 = lane * 4;
      if (nib & 1u) L[at++] = (unsigned short)c0;
      if (nib & 2u) L[at++] = (unsigned short)(c0 + 1);
      if (nib & 4u) L[at++] = (unsigned short)(c0 + 2);
      if (nib & 8u) L[at] = (unsigned short)(c0 + 3);
    }
    __syncwarp();
    const long long x0 = (long long)c * kTileC;
    const float* xb = x + x0 * k;
    const int rows_left = (int)min((long long)kTileC, (long long)n - x0);
    if (one_sweep) {
      if (r != row) {
        if (row >= 0)
          flush<NP>(acc, dirty, y, (long long)row * kTileR + wi * kRows, k,
                    cs, cp, lead);
        dirty = 0;
        row = r;
      }
      walk<DT, NP, false>(tile, lst, cnt, most, share, shares, xb,
                          rows_left, k, cs, acc);
      dirty |= touched;
      // a non-finite X block: the stored zeros count too (0 * Inf =
      // NaN), as in the dense tile product
      if (!fin) {
        walk<DT, NP, true>(tile, lst, cnt, kTileC, share, shares, xb,
                           rows_left, k, cs, acc);
        dirty = all;
      }
    } else {
      const long long y0 = (long long)r * kTileR + wi * kRows;
      for (int g = 0; g < k; g += NP * kPassCols) {
        const Cols<NP> cg = cols_of<NP>(g, jl, k);
        walk<DT, NP, false>(tile, lst, cnt, most, share, shares, xb,
                            rows_left, k, cg, acc);
        if (!fin)
          walk<DT, NP, true>(tile, lst, cnt, kTileC, share, shares, xb,
                             rows_left, k, cg, acc);
        flush<NP>(acc, fin ? touched : all, y, y0, k, cg, cp, lead);
      }
    }
    __syncwarp();                                // slot s and the list free
    s = s + 1 == S ? 0 : s + 1;
    s_next = s_next + 1 == S ? 0 : s_next + 1;
  }
  if (one_sweep && row >= 0)
    flush<NP>(acc, dirty, y, (long long)row * kTileR + wi * kRows, k, cs, cp,
              lead);
}

template <int DT, int NP>
int launch_tiled_spmm(const void* tiles, const int* tile_rows,
                      const int* tile_cols, const float* x, int* finite,
                      float* y, int num_tiles, int n, int k, int sm_count,
                      cudaStream_t s) {
  static int per_sm = 0;                         // resident blocks per SM
  if (per_sm == 0) {
    int got = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &got, tiled_spmm_kernel<DT, NP>, kSpmmWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
    per_sm = got > 0 ? got : 1;
  }
  const long long chunks = ((long long)num_tiles + kChunk - 1) / kChunk;
  const long long grid = std::min(chunks, (long long)sm_count * per_sm);
  const long long xblocks = ((long long)n + kTileC - 1) / kTileC;
  x_block_finite_kernel<DT><<<(unsigned)xblocks, kFiniteThreads, 0, s>>>(
      x, finite, n, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tiled_spmm_kernel<DT, NP><<<(unsigned)grid, kSpmmWarps * 32, 0, s>>>(
      static_cast<const typename Tile<DT>::T*>(tiles), tile_rows, tile_cols,
      x, finite, y, num_tiles, n, k);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_tiled_spmm(const void* tiles, const int* tile_rows,
                      const int* tile_cols, const float* x, int* finite,
                      float* y, int num_tiles, int n, int k, int sm_count,
                      cudaStream_t s) {
  if (k <= kPassCols)
    return launch_tiled_spmm<DT, 1>(tiles, tile_rows, tile_cols, x, finite,
                                    y, num_tiles, n, k, sm_count, s);
  if (k <= 2 * kPassCols)
    return launch_tiled_spmm<DT, 2>(tiles, tile_rows, tile_cols, x, finite,
                                    y, num_tiles, n, k, sm_count, s);
  return launch_tiled_spmm<DT, 4>(tiles, tile_rows, tile_cols, x, finite, y,
                                  num_tiles, n, k, sm_count, s);
}

// ---------------------------------------------------------------- K5 ----
// The compact operand (repro_torch.kernels.bsr_spmv._compact_tiles): the
// stored nonzeros of the tile stream, tile by tile in visit order, each in
// row-major order within its tile. nz_ptr[T + 1] bounds tile t's entries;
// entry e holds pos[e] = (t % 32) << 10 | r << 7 | c (u16) and its value
// vals[e] in the tile dtype. pos and vals are zero-padded to a multiple
// of 8 entries. work[I][3] lists the warps' items: a chunk of 32 tiles and
// a span lo : hi of its entries (lo a multiple of 8, at most 1,024
// entries); a chunk with more entries (mawi_like's dense row) is split
// over several warps, each adding its own sums into Y.
constexpr int kSpmvWarps = 8;        // warps per block
constexpr int kSpmvChunk = 32;       // tiles per warp = the local tile field
constexpr int kSpmvEntries = 8;      // consecutive entries a lane takes
constexpr int kSpmvPass = 32 * kSpmvEntries;
constexpr int kPrepassWarps = 8;     // the X pre-pass: a warp per X block

// eight consecutive operand values (32-byte aligned f32, 16-byte aligned
// bf16), and eight packed positions (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const unsigned short* p, float (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const unsigned short* p, int (&v)[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = (int)(w[i] & 0xffffu);
    v[2 * i + 1] = (int)(w[i] >> 16);
  }
}

// K5's pre-pass (k = 1): finite[b] as x_block_finite_kernel gives it, a
// warp per X block (a float4 of its 128 values a lane), and each block
// zeroes its y_share floats of y (a multiple of 4).
template <int DT>
__global__ void __launch_bounds__(kPrepassWarps * 32)
spmv_prepass_kernel(const float* __restrict__ x, int* __restrict__ finite,
                    int n, float* __restrict__ y, long long m_pad,
                    long long y_share) {
  const int lane = threadIdx.x % 32;
  const long long b =
      (long long)blockIdx.x * kPrepassWarps + threadIdx.x / 32;
  const long long r0 = b * kTileC;
  if (r0 < n) {                                  // the same for the warp
    const long long r1 = min(r0 + kTileC, (long long)n);
    const long long e = r0 + 4LL * lane;
    int ok = 1;
    if (e + 4 <= r1) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + e));
      ok = isfinite(x_in<DT>(v.x)) & isfinite(x_in<DT>(v.y)) &
           isfinite(x_in<DT>(v.z)) & isfinite(x_in<DT>(v.w));
    } else {
      for (long long j = e; j < r1; ++j) ok &= isfinite(x_in<DT>(x[j]));
    }
    ok = __all_sync(kFull, ok);
    if (lane == 0) finite[b] = ok ? 1 : 0;
  }
  const long long y0 = (long long)blockIdx.x * y_share;
  const long long y1 = min(y0 + y_share, m_pad);
  for (long long j = y0 + 4LL * threadIdx.x; j < y1;
       j += 4LL * kPrepassWarps * 32)
    *reinterpret_cast<float4*>(y + j) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One warp per work item, a span of the entries of a chunk of 32
// consecutive tiles; lane i holds tile t0 + i's row, column, X-block flag
// and run (the chunk's consecutive tiles of one tile row). The lanes take
// the span's entries 8 consecutive ones each, 256 a pass, all loads of a
// pass issued before any use. Sums go to a shared slot per (run, tile
// row); at the end each nonzero slot is added into Y once.
template <int DT>
__global__ void __launch_bounds__(kSpmvWarps * 32)
tiled_spmv_kernel(const int* __restrict__ nz_ptr,
                  const unsigned short* __restrict__ pos,
                  const typename Tile<DT>::T* __restrict__ vals,
                  const int* __restrict__ work, int items,
                  const typename Tile<DT>::T* __restrict__ tiles,
                  const int* __restrict__ tile_rows,
                  const int* __restrict__ tile_cols,
                  const float* __restrict__ x, const int* __restrict__ finite,
                  float* __restrict__ y, int num_tiles, int n) {
  __shared__ float sums[kSpmvWarps][kSpmvChunk * kTileR];
  __shared__ int run_rows[kSpmvWarps][kSpmvChunk];
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kSpmvWarps + wi;
  if (item >= items) return;                     // the whole warp
  const long long t0 = (long long)__ldg(work + 3 * item) * kSpmvChunk;
  const int lo = __ldg(work + 3 * item + 1);
  const int hi = __ldg(work + 3 * item + 2);
  const int nt = (int)min((long long)kSpmvChunk, num_tiles - t0);
  int trow = -1, tcol = 0;
  if (lane < nt) {
    trow = __ldg(tile_rows + t0 + lane);
    tcol = __ldg(tile_cols + t0 + lane);
  }
  // the span's entries: [e0, e1); the chunk's first item also walks the
  // zeros of tiles over non-finite X blocks
  const int c0 = __ldg(nz_ptr + t0);
  const int e0 = max(c0, lo), e1 = hi;
  const int fin = lane < nt && lo <= c0 ? __ldg(finite + tcol) : 1;
  // a run starts where the tile row changes; run = the lane's run id
  const int above = __shfl_up_sync(kFull, trow, 1);
  const unsigned heads =
      __ballot_sync(kFull, lane < nt && (lane == 0 || trow != above));
  const int run = __popc(heads & (kFull >> (31 - lane))) - 1;
  float* acc = sums[wi];
  if (heads >> lane & 1u) run_rows[wi][run] = trow;
#pragma unroll
  for (int j = lane; j < kSpmvChunk * kTileR; j += 32) acc[j] = 0.f;
  __syncwarp();

  for (int eb = lo; eb < e1; eb += kSpmvPass) {
    const int g = eb + lane * kSpmvEntries;
    const bool any = g < e1 && g + kSpmvEntries > e0;
    int ps[kSpmvEntries];
    float a[kSpmvEntries], xv[kSpmvEntries];
    int key[kSpmvEntries];
    if (any) {
      load8(pos + g, ps);
      load8(vals + g, a);
    } else {
#pragma unroll
      for (int u = 0; u < kSpmvEntries; ++u) {
        ps[u] = 0;
        a[u] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSpmvEntries; ++u) {
      const bool ok = any && g + u >= e0 && g + u < e1;
      const int i = ps[u] >> 10 & (kSpmvChunk - 1);
      const int c = __shfl_sync(kFull, tcol, i);
      const int rn = __shfl_sync(kFull, run, i);
      const long long xc = (long long)c * kTileC + (ps[u] & (kTileC - 1));
      xv[u] = ok && xc < n ? __ldg(x + xc) : 0.f;
      key[u] = ok ? rn * kTileR + (ps[u] >> 7 & (kTileR - 1)) : -1;
    }
    // the lane's consecutive entries of one (run, row) summed, then one
    // shared add
    float s = 0.f;
    int cur = -1;
#pragma unroll
    for (int u = 0; u < kSpmvEntries; ++u) {
      if (key[u] < 0) continue;
      if (key[u] != cur) {
        if (cur >= 0) atomicAdd(acc + cur, s);
        cur = key[u];
        s = 0.f;
      }
      s = fmaf(a[u], x_in<DT>(xv[u]), s);
    }
    if (cur >= 0) atomicAdd(acc + cur, s);
  }

  // a tile over a non-finite X block also adds its stored zeros' 0 * x
  // (NaN where x is NaN or Inf), read from the dense tile
  unsigned bad = __ballot_sync(kFull, !fin);
  while (bad) {
    const int i = __ffs(bad) - 1;
    bad &= bad - 1u;
    const int c = __shfl_sync(kFull, tcol, i);
    const int rn = __shfl_sync(kFull, run, i);
    const long long xc = (long long)c * kTileC + lane * 4;
    float xq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xq[j] = xc + j < n ? x_in<DT>(__ldg(x + xc + j)) : 0.f;
    const typename Tile<DT>::T* tp =
        tiles + (t0 + i) * kTileElems + lane * 4;
#pragma unroll
    for (int r = 0; r < kTileR; ++r) {
      const float4 q = Tile<DT>::load4(tp + r * kTileC);
      const float qa[4] = {q.x, q.y, q.z, q.w};
      float z = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (qa[j] == 0.f) z = fmaf(qa[j], xq[j], z);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        z += __shfl_xor_sync(kFull, z, off);
      if (lane == 0) atomicAdd(acc + rn * kTileR + r, z);
    }
  }
  __syncwarp();

  // one add into Y per (run, row) with a nonzero sum: a zero sum would not
  // change Y, which starts at +0
  const int runs = __popc(heads);
  for (int j = lane; j < runs * kTileR; j += 32) {
    const float s = acc[j];
    if (s != 0.f)
      atomicAdd(y + (long long)run_rows[wi][j / kTileR] * kTileR +
                    j % kTileR, s);
  }
}

template <int DT>
int launch_tiled_spmv(const int* nz_ptr, const unsigned short* pos,
                      const void* vals, const int* work, int items,
                      const void* tiles, const int* tile_rows,
                      const int* tile_cols, const float* x, int* finite,
                      float* y, int num_tiles, int n, long long m_pad,
                      cudaStream_t s) {
  using T = typename Tile<DT>::T;
  const long long xblocks = ((long long)n + kTileC - 1) / kTileC;
  const long long pre = (xblocks + kPrepassWarps - 1) / kPrepassWarps;
  // each pre-pass block zeroes a multiple of 4 of y's m_pad (a multiple
  // of 8) floats
  const long long y_share = ((m_pad + pre - 1) / pre + 3) & ~3LL;
  spmv_prepass_kernel<DT><<<(unsigned)pre, kPrepassWarps * 32, 0, s>>>(
      x, finite, n, y, m_pad, y_share);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)items + kSpmvWarps - 1) / kSpmvWarps;
  tiled_spmv_kernel<DT><<<(unsigned)blocks, kSpmvWarps * 32, 0, s>>>(
      nz_ptr, pos, static_cast<const T*>(vals), work, items,
      static_cast<const T*>(tiles), tile_rows, tile_cols, x, finite, y,
      num_tiles, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5. The compact operand: nz_ptr i32[T + 1], pos u16 and vals (tile
// dtype) padded to a multiple of 8 entries (pos 16-byte, vals 32-byte
// aligned), work i32[items][3]; tiles [T, 8, 128] (tile_dtype 0 = f32,
// 1 = bf16; read only over non-finite X blocks), tile_rows / tile_cols
// i32[T], x f32[n] (16-byte aligned), finite i32[ceil(n / 128)] scratch,
// y f32[m_pad] (16-byte aligned), zeroed here. Launches the pre-pass (X
// flags, y zeroed), then the multiply. Returns cudaGetLastError().
int tiled_spmv_launch(const int* nz_ptr, const void* pos, const void* vals,
                      const int* work, int items, const void* tiles,
                      int tile_dtype, const int* tile_rows,
                      const int* tile_cols, const float* x, int* finite,
                      float* y, int num_tiles, int n, long long m_pad,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (num_tiles <= 0 || items <= 0)
    return (int)cudaMemsetAsync(y, 0, (size_t)m_pad * sizeof(float), s);
  if (n <= 0 || m_pad % 4) return (int)cudaErrorInvalidValue;
  const unsigned short* p = static_cast<const unsigned short*>(pos);
  if (tile_dtype == kF32)
    return launch_tiled_spmv<kF32>(nz_ptr, p, vals, work, items, tiles,
                                   tile_rows, tile_cols, x, finite, y,
                                   num_tiles, n, m_pad, s);
  if (tile_dtype == kBF16)
    return launch_tiled_spmv<kBF16>(nz_ptr, p, vals, work, items, tiles,
                                    tile_rows, tile_cols, x, finite, y,
                                    num_tiles, n, m_pad, s);
  return (int)cudaErrorInvalidValue;
}

// K6 and K7: the same launch, which reads the stream once whatever K6's
// column tile is. tiles as above, x f32[n, k] (16-byte
// aligned), finite i32[ceil(n / 128)] scratch, y f32[m_pad, k] zeroed by
// the caller, sm_count the card's SMs (the persistent grid). Launches the
// X pre-pass, then the multiply. Returns cudaGetLastError().
int tiled_spmm_launch(const void* tiles, int tile_dtype, const int* tile_rows,
                      const int* tile_cols, const float* x, int* finite,
                      float* y, int num_tiles, int n, int k, int sm_count,
                      void* stream) {
  if (num_tiles <= 0 || k <= 0) return 0;
  if (n <= 0 || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile_dtype == kF32)
    return launch_tiled_spmm<kF32>(tiles, tile_rows, tile_cols, x, finite, y,
                                   num_tiles, n, k, sm_count, s);
  if (tile_dtype == kBF16)
    return launch_tiled_spmm<kBF16>(tiles, tile_rows, tile_cols, x, finite,
                                    y, num_tiles, n, k, sm_count, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
