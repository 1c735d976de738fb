// K1 — SELL-C-sigma slot-space SpMM on Hopper (sm_90a),
// K8 — the same with the compact-X gather fused in, and
// K3 — its transpose (further down).
//
// K1 replaces: repro/spmm/kernels.py `sellcs_slots` / `_sellcs_kernel`, the
// Pallas TPU kernel that computes
//     Y[slice_of[w] * C + l, :] += data[w, l] * X[cols[w, l], :]
// over a k-tiled grid, eight width-rows per grid step, with the Y slab
// resident in VMEM across the sequential matrix-stream axis. K8 replaces
// `sellcs_slots(col_map=...)` / `_sellcs_fused_kernel`, the
// `gather="fused"` mode of the distributed multiplies: a shard's stored
// cols are compact ids into its touched column set, and col_map names the
// row of the full X each one reads, X[col_map[cols[w, l]], :]. Both
// entry points run one kernel body; K8 adds one load per staged entry.
//
// Bound on this card: bytes. The function needs 4 B value + 4 B column
// per nonzero and one row offset per row, X read once and Y written once
// (K8: X only at the touched rows, plus one int32 of col_map each); at 2
// flops per nonzero and column the intensity stays far below the H100's
// f32 ridge (~20 flop/byte), so the least time is those bytes over
// 3.35 TB/s. In practice the random X gathers set the pace: at hhh_like
// --scale 64, k = 32, each nonzero reads a 128-byte X row from a 128 MiB X
// that L2 (50 MB) cannot hold, 0.552 ms if every one missed.
//
// Design. The TPU kernel carries its sums across grid steps in VMEM; here
// blocks run in no order, so the stream is cut into work items by a plan
// built once per stream (repro_torch/spmm/slots_plan.py, from slice_ptr
// and row_len, with torch ops on the stream's device, kept on slice_ptr).
//   * Work item: one slice's group of 32 consecutive lanes over a depth
//     range of at most D width-rows (the plan's depth, 32). A group's
//     range stops at its longest real row (max row_len), not at the
//     slice's width, and a deeper range is cut into pieces of D, so a
//     slice hundreds of thousands of width-rows deep (mawi_like's dense
//     row) spreads over as many items as its depth asks for.
//   * Padding costs nothing: each lane stops at its own row's end
//     (base + row_len, base the slice's depth base, negative for a shard
//     that starts mid-slice), so its padding is neither loaded nor
//     gathered. The plan marks a group whose every lane reaches its end
//     (no row_len read: road_like's uniform rows) and, per item, the last
//     lane with entries (later pieces of a dense row skip the warps of
//     the lanes that have ended).
//   * Columns: a thread takes 4 consecutive columns, as 16-byte loads of
//     X where k % 4 == 0 and X is 16-byte aligned, else as 4 scalars plus
//     one tail column (k = 33: 8 threads a lane, one pass); TPL threads
//     serve one lane (k <= 8: 2, <= 16: 4, <= 32: 8, else 16; k = 1: one
//     lane a thread), a warp 32 / TPL lanes at once, and an item takes
//     min(TPL, 8) warps, so the lanes of a group are walked side by side.
//     Each thread loads its own lane's value and column (the TPL threads
//     of a lane read one address; K8 maps the column through col_map
//     here) a batch of kGather = 8 width-rows ahead (4 with a tail
//     column), and issues the X rows of a batch before the first FMA that
//     uses them: 32 X rows in flight a warp at k = 32, 256 at k = 1.
//     The data/cols loads are streaming (ld.global.cs, evict first): the
//     stream is read once a call, so L2 keeps the X rows, the plan's items
//     and Y instead (road_like, k = 1: 0.0200 ms against 0.0275 with
//     plain __ldg loads; an L2::evict_first cache policy gave the same).
//     k > 64 (k > 80 unaligned) takes column blocks on grid.y, each
//     reading the stream again. Registers are capped so that four blocks
//     of 256 threads fit an SM (two with a tail column).
//   * Output: a group covered by one item writes its slots straight into
//     Y. In a group cut into pieces, a lane whose row ends inside the
//     first piece (or has no entries) is written straight too; a lane with
//     entries in n >= 2 pieces writes piece i's partial to scratch row
//     lane_base + i, and a combine kernel adds each such lane's partials
//     (a block per lane and column: 256 strided sums in piece order, then
//     a fixed tree) and writes its slot. No atomics: every element is
//     written by one thread in a fixed order, so two launches are bitwise
//     equal, and K8 on the full X equals K1 on the up-front slab X[col_map]
//     bitwise (same plan, same arithmetic per slot).
//   * Without row_len the plan caps each group at the slice's width and
//     the padding entries (data 0, column 0) are read and added, as the
//     reference does; deep slices are still split.
// Tried and dropped (PERF.md, K1/K8's designs tried): a warp per item
// staging the item's data/cols in shared memory once and walking the
// group's lanes in TPL passes from there (8 KB a warp; slower at k = 1
// and 8 on hhh_like, faster at k = 33 before the tail layout), items of
// 8 and 16 width-rows
// (more items and combine work: slower at every matrix), 16 X rows in
// flight a thread (more registers, fewer warps: slower), 4 at k = 1,
// tighter register caps (spills), one block a group of items walking
// the grid with the next item's meta loaded ahead (road_like, k = 1:
// 0.0247 ms against 0.0277, but 7-35 % slower at k >= 8), a combine in
// levels of 32 partials a thread (three launches at mawi_like's dense
// row; 9.2 us of 35.6 at k = 1).
// Not yet: writing Y through row_perm from the kernel (the caller's
// un-permute scatter is a separate pass), a slice height chosen for the
// card (the stream keeps the reference's C = 128).
//
// The earlier design: block (s, b) owned slice s, each thread one
// (lane, column) slot walking every width-row of the slice alone in
// order. It read the padding, could not split a deep slice (54 ms at
// mawi_like --scale 4, where cuSPARSE takes 0.07-0.26) and had one X row
// in flight a lane-column.

#include <cuda_runtime.h>
#include <stdint.h>

// A plan as the entry points take it: one host struct a plan, built once
// by repro_torch/spmm/slots_plan.py (SlotsPlan.c_args), so a launch
// passes one pointer for it.
struct PlanArgs {
  const int* items;             // int32[n_items, 8]
  long long n_items;
  const int* lane_base;         // int32[n_split * 32]
  const int* segs;              // int32[n_segs, 4]
  long long n_segs;
  const int* row_len;           // int32[len_slots], or null: no stop
  long long len_slots;
  long long chunk;
};

namespace {

constexpr unsigned kWarpMask = 0xffffffffu;
constexpr int kThreads = 256;      // threads a block of the items kernel
// X rows a thread has in flight, and the least blocks of the items kernel
// an SM must hold (a register cap), by column layout L (below): measured
// on the card (PERF.md)
__host__ __device__ constexpr int gather_of(int L) { return L == 6 ? 4 : 8; }
__host__ __device__ constexpr int min_blocks_of(int L) {
  return L == 6 ? 2 : 4;
}
constexpr int kCombineThreads = 256;

// The columns of one thread, as it loads them from an X row and stores
// them to a Y row: L = 4, four as one float4 at jl (k % 4 == 0, X 16-byte
// aligned); L = 6, four scalars at jl (nv of them below k) plus one tail
// column jt (used when jt < k), at any alignment, so TPL threads cover
// 5 * TPL columns (k = 33: 8 threads a lane, column 32 in thread 0);
// L = 1, one (k = 1).
template <int L> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static constexpr int kCols = 4;
  __device__ __forceinline__ static T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static T load(const float* row, int, int jl,
                                           int, int) {
    return __ldg(reinterpret_cast<const float4*>(row + jl));
  }
  __device__ __forceinline__ static void fma(float v, const T& x, T& a) {
    a.x = fmaf(v, x.x, a.x);
    a.y = fmaf(v, x.y, a.y);
    a.z = fmaf(v, x.z, a.z);
    a.w = fmaf(v, x.w, a.w);
  }
  __device__ __forceinline__ static void store(float* row, const T& a, int,
                                               int jl, int, int) {
    *reinterpret_cast<float4*>(row + jl) = a;
  }
};
struct Cols6 {
  float4 m;
  float t;
};
template <> struct Vec<6> {
  using T = Cols6;
  static constexpr int kCols = 5;
  __device__ __forceinline__ static T zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f), 0.f};
  }
  __device__ __forceinline__ static T load(const float* row, int nv,
                                           int jl, int jt, int k) {
    T v = zero();
    if (nv > 0) v.m.x = __ldg(row + jl);
    if (nv > 1) v.m.y = __ldg(row + jl + 1);
    if (nv > 2) v.m.z = __ldg(row + jl + 2);
    if (nv > 3) v.m.w = __ldg(row + jl + 3);
    if (jt < k) v.t = __ldg(row + jt);
    return v;
  }
  __device__ __forceinline__ static void fma(float v, const T& x, T& a) {
    Vec<4>::fma(v, x.m, a.m);
    a.t = fmaf(v, x.t, a.t);
  }
  __device__ __forceinline__ static void store(float* row, const T& a,
                                               int nv, int jl, int jt,
                                               int k) {
    if (nv > 0) row[jl] = a.m.x;
    if (nv > 1) row[jl + 1] = a.m.y;
    if (nv > 2) row[jl + 2] = a.m.z;
    if (nv > 3) row[jl + 3] = a.m.w;
    if (jt < k) row[jt] = a.t;
  }
};
template <> struct Vec<1> {
  using T = float;
  static constexpr int kCols = 1;
  __device__ __forceinline__ static T zero() { return 0.f; }
  __device__ __forceinline__ static T load(const float* row, int, int jl,
                                           int, int) {
    return __ldg(row + jl);
  }
  __device__ __forceinline__ static void fma(float v, const T& x, T& a) {
    a = fmaf(v, x, a);
  }
  __device__ __forceinline__ static void store(float* row, const T& a, int,
                                               int jl, int, int) {
    row[jl] = a;
  }
};

// items: int32[n_items, 8] = {slot0, w_lo, w_hi, base, g_end, piece,
// split, lane0 * 64 + n_live}: the group's first slot, the item's
// width-rows [w_lo, w_hi), the slice's depth base, the group's walk end,
// the piece's index in its group, the group's split id (-1: one piece;
// -2: one piece whose every lane reaches g_end, no row_len read; >= 0:
// cut into pieces), its first lane in the slice, and 1 + the last lane
// with entries in the item. lane_base: int32[n_split * 32], the scratch
// row of piece 0 of each split group's lane (-1: written straight to Y).
//
// An item takes WPI = min(TPL, 8) warps, each serving 32 / TPL lanes of
// the group in TPL / WPI passes; each thread loads its own lane's
// data/cols (the TPL threads of a lane read one address), a batch of
// kGather width-rows ahead of the X rows it gathers for the batch before.
template <int TPL, int L>
__global__ void __launch_bounds__(kThreads, min_blocks_of(L))
sellcs_items_kernel(const float* __restrict__ data,
                    const int* __restrict__ cols,
                    const int* __restrict__ col_map,
                    const int* __restrict__ row_len, long long len_slots,
                    const int4* __restrict__ items, long long n_items,
                    const int* __restrict__ lane_base,
                    const float* __restrict__ x, float* __restrict__ y,
                    float* __restrict__ part, int chunk, int k) {
  using V = Vec<L>;
  constexpr int VEC = V::kCols;
  constexpr int kGather = gather_of(L);
  constexpr int MAIN = L == 1 ? 1 : 4;       // contiguous columns a thread
  constexpr int LPW = 32 / TPL;              // lanes a warp serves at once
  constexpr int WPI = TPL < 8 ? TPL : 8;     // warps an item
  constexpr int IPB = kThreads / 32 / WPI;   // items a block
  constexpr int PPW = TPL / WPI;             // passes a warp
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * IPB + warp / WPI;
  if (item >= n_items) return;               // the item's whole warps
  const int4 a = items[2 * item], b = items[2 * item + 1];
  const long long slot0 = a.x;
  const int w_lo = a.y, w_hi = a.z, base = a.w;
  const int g_end = b.x, piece = b.y, split = b.z;
  const int lane0 = b.w >> 6, n_live = b.w & 63;
  const int nl = min(32, chunk - lane0);     // lanes of the group
  // a later piece writes only its live lanes: a warp with none is done
  if (piece > 0 && (warp % WPI) * PPW * LPW >= n_live) return;
  const int jq = t % TPL;
  const int c0 = blockIdx.y * (TPL * VEC);  // the block's first column
  const int jl = c0 + jq * MAIN;            // the thread's main columns
  const int jt = L == 6 ? c0 + TPL * MAIN + jq : k;    // and tail column
  const int nv = min(MAIN, k - jl);
  const bool col_ok = nv > 0 || jt < k;
#pragma unroll
  for (int pp = 0; pp < PPW; ++pp) {
    const int lq = ((warp % WPI) * PPW + pp) * LPW + t / TPL;
    int my_stop = w_lo;                      // the lane's stop
    if (lq < n_live) {                       // (a lane past it: no entries)
      my_stop = g_end;
      // split == -2: the plan saw every lane of the group reach g_end
      if (row_len != nullptr && split != -2) {
        const long long s = slot0 + lq;
        const long long len = s < len_slots ? (long long)row_len[s] : 0;
        my_stop = (int)min((long long)g_end, (long long)base + len);
      }
    }
    const int live_end = min(my_stop, w_hi);
    // the pass ends at its deepest lane's stop (warp-uniform)
    const int pass_end = __reduce_max_sync(kWarpMask, live_end);
    const float* dp = data + lane0 + lq;
    const int* cp = cols + lane0 + lq;
    float dn[kGather];
    int cn[kGather];
    auto fetch = [&](int w0) {
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        const int w = w0 + i;
        const bool live = w < live_end;
        const long long e = (long long)w * chunk;
        dn[i] = live ? __ldcs(dp + e) : 0.f;
        cn[i] = live ? __ldcs(cp + e) : -1;
      }
      if (col_map != nullptr) {              // K8: the fused gather
#pragma unroll
        for (int i = 0; i < kGather; ++i)
          if (cn[i] >= 0) cn[i] = __ldg(col_map + cn[i]);
      }
    };
    typename V::T acc = V::zero();
    if (w_lo < pass_end) fetch(w_lo);
    for (int w0 = w_lo; w0 < pass_end; w0 += kGather) {
      float dv[kGather];
      int cv[kGather];
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        dv[i] = dn[i];
        cv[i] = cn[i];
      }
      if (w0 + kGather < pass_end) fetch(w0 + kGather);   // in flight below
      typename V::T xv[kGather];
      // every gather of the batch is issued before the first FMA
#pragma unroll
      for (int i = 0; i < kGather; ++i)
        xv[i] = (cv[i] >= 0 && col_ok)
                    ? V::load(x + (long long)cv[i] * k, nv, jl, jt, k)
                    : V::zero();
#pragma unroll
      for (int i = 0; i < kGather; ++i)
        if (cv[i] >= 0) V::fma(dv[i], xv[i], acc);
    }
    if (lq < nl && col_ok) {
      float* dst = nullptr;
      if (split < 0 || (piece == 0 && my_stop <= w_hi))
        dst = y + (slot0 + lq) * k;
      else if (w_lo < my_stop)
        dst = part + (long long)(lane_base[split * 32 + lq] + piece) * k;
      if (dst != nullptr) V::store(dst, acc, nv, jl, jt, k);
    }
  }
}

// One block per (segment, column): segment {src, count, slot, 0} adds one
// lane's partials, scratch rows src .. src + count - 1, and writes the sum
// to Y's row slot. Thread t adds rows t, t + 256, ... in order, then the
// block adds the 256 sums in a fixed tree (warp shuffles, then the warps'
// sums in order), so the sum is the same launch after launch.
__global__ void __launch_bounds__(kCombineThreads)
sellcs_combine_kernel(const int4* __restrict__ segs,
                      const float* __restrict__ part,
                      float* __restrict__ y, int k) {
  __shared__ float warp_sum[kCombineThreads / 32];
  const int4 s = segs[blockIdx.x];
  const int j = blockIdx.y;
  const float* src = part + (long long)s.x * k + j;
  float sum = 0.f;
#pragma unroll 4
  for (int r = threadIdx.x; r < s.y; r += kCombineThreads)
    sum += src[(long long)r * k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(kWarpMask, sum, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kCombineThreads / 32; ++w) total += warp_sum[w];
    y[(long long)s.z * k + j] = total;
  }
}

template <int TPL, int L>
cudaError_t launch_items(const float* data, const int* cols,
                         const int* col_map, const int* row_len,
                         long long len_slots, const int* items,
                         long long n_items, const int* lane_base,
                         const float* x, float* y, float* part, int chunk,
                         int k, cudaStream_t stream) {
  const int per_block = TPL * Vec<L>::kCols;
  const int col_blocks = (k + per_block - 1) / per_block;
  constexpr int ipb = kThreads / 32 / (TPL < 8 ? TPL : 8);
  const long long blocks = (n_items + ipb - 1) / ipb;
  if (blocks > 2147483647LL || col_blocks > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)col_blocks);
  sellcs_items_kernel<TPL, L><<<grid, kThreads, 0, stream>>>(
      data, cols, col_map, row_len, len_slots,
      reinterpret_cast<const int4*>(items), n_items, lane_base, x, y, part,
      chunk, k);
  return cudaGetLastError();
}

// The items kernel at the column layout k asks for, then the combine
// kernel when the plan cut a group into pieces.
int run_slots(const float* data, const int* cols, const int* col_map,
              const PlanArgs* p, const float* x, float* y, float* part,
              int k, void* stream) {
  const int chunk = (int)p->chunk;
  if (p->n_items <= 0 || chunk <= 0 || k <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool v4 = k % 4 == 0 && ((uintptr_t)x & 15u) == 0;
  cudaError_t err;
#define REPRO_K1(TPL, L)                                                   \
  err = launch_items<TPL, L>(data, cols, col_map, p->row_len,              \
                             p->len_slots, p->items, p->n_items,           \
                             p->lane_base, x, y, part, chunk, k, st)
  if (k == 1) REPRO_K1(1, 1);
  else if (v4 && k <= 4) REPRO_K1(1, 4);
  else if (v4 && k <= 8) REPRO_K1(2, 4);
  else if (v4 && k <= 16) REPRO_K1(4, 4);
  else if (v4 && k <= 32) REPRO_K1(8, 4);
  else if (v4) REPRO_K1(16, 4);
  else if (k <= 5) REPRO_K1(1, 6);
  else if (k <= 10) REPRO_K1(2, 6);
  else if (k <= 20) REPRO_K1(4, 6);
  else if (k <= 40) REPRO_K1(8, 6);
  else REPRO_K1(16, 6);
#undef REPRO_K1
  if (err != cudaSuccess) return (int)err;
  if (p->n_segs > 0) {
    if (p->n_segs > 2147483647LL || k > 65535)
      return (int)cudaErrorInvalidConfiguration;
    sellcs_combine_kernel<<<dim3((unsigned)p->n_segs, (unsigned)k),
                            kCombineThreads, 0, st>>>(
        reinterpret_cast<const int4*>(p->segs), part, y, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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

// K1. data f32[W, C], cols i32[W, C], the plan (PlanArgs, host), x
// f32[n, k], y f32[S*C, k] (every element written), part f32[plan scratch
// rows, k] (null when the plan has none). Returns the first
// cudaGetLastError() that is not cudaSuccess, else 0.
int sellcs_slots_launch(const float* data, const int* cols,
                        const PlanArgs* plan, const float* x, float* y,
                        float* part, int k, void* stream) {
  return run_slots(data, cols, nullptr, plan, x, y, part, k, stream);
}

// K8: as sellcs_slots_launch, with cols compact ids into col_map i32[Ntc]
// and x the full f32[n, k].
int sellcs_slots_fused_launch(const float* data, const int* cols,
                              const int* col_map, const PlanArgs* plan,
                              const float* x, float* y, float* part, int k,
                              void* stream) {
  return run_slots(data, cols, col_map, plan, x, y, part, k, stream);
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
