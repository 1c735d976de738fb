// K2 / K4 — merge-path CSR SpMM / SpMV on Hopper (sm_90a), plus the carry
// step that replaces the reference's carry-out fixup.
//
// Replaces:
//   K2  repro/spmm/kernels.py `_merge_spmm_partials` / `_merge_kernel`
//   K4  repro/kernels/merge_spmv.py `merge_spmv_partials` / `_kernel`
//   and repro/kernels/merge_spmv.py `carry_out_fixup` (a jnp scatter-add).
// The TPU kernels reduce each merge span of D items into span-local rows
// with a one-hot (D x R) matmul on the MXU and write a (P, R, Kp) f32
// partials buffer that `carry_out_fixup` scatter-adds into Y — 1.76 GB at
// hhh_like --scale 64, k = 32. That buffer is the MXU idiom, not part of
// the function: here no (P, R, k) buffer exists.
//
// Bound on this card: bytes. The function needs the CSR stream (4 B value
// + 4 B column per nonzero, 4 B row offset per row), X read once and Y
// written once; at 2 flops per nonzero and column the intensity is far
// below the f32 ridge. The plan's per-item row ids (seg) and the carry
// buffer are this design's overhead on top of that bound.
//
// K2's design. One block of 256 threads per span p, cut into chains of S
// lanes (S = k / 4 rounded up to a power of two in [2, 32], each lane 4
// consecutive columns: as float4 where k % 4 == 0, as scalars where
// k > 32; else S = k rounded up, one column a lane; wider k takes passes
// of S * 4 or S columns). A chain
// owns a contiguous share of the span's items: k = 32 gives 32 chains of
// 8 lanes, ~415 items each at hhh_like 64 (the parent kernel had 8
// chains of 32 lanes walking one item at a time). A chain stages its next
// items with one coalesced 4-byte load per lane from each of cols, vals
// and seg (up to 32 items, loaded while the items before are summed) and
// hands them out by shuffles; it issues the X rows of 4 items before the
// first FMA that uses them, so a warp has up to 16 X rows in flight and a
// block 128 (X is 128 MiB at hhh_like 64 with random columns: latency-
// bound gathers, as K1's). Each chain runs a sequential segmented sum: a
// row whose items all lie in its share is written straight into Y, its
// first and last rows go to shared memory. The entries that name a row
// are compacted in order (a ballot), and the head of each run of equal
// rows sums the run in chain order, per column: rows inside the span go
// into Y, the span's own first and last rows — the only rows a
// neighbouring span can share — to the [P, 2, k] carry buffer with their
// global row ids (-1 for none). The carry step (below) then adds, for each
// row, all carries naming it into Y. Every output element is written by one
// thread once, in a fixed order, so K2 is deterministic and needs no
// atomics; Y must start zeroed (rows with no items are never written).
//
// K4's design (k = 1, a kernel of its own). At k = 1 K2's groups are
// single threads ~48 items apart, so their loads neither coalesce nor
// overlap, and one thread walks the 512 shared entries. K4 instead is a
// block-wide reduce-by-key. One block of 256 threads per span walks it in
// tiles of 1,024 consecutive items: each warp loads its 128 items of
// cols, vals and seg with 4-byte loads at consecutive addresses (so any
// span start D * p works, aligned or not) while the tile before is being
// reduced, and transposes them through shared memory so that each thread
// holds 4 consecutive items. A thread sums its items by row; a segmented
// scan over the threads (warp shuffles, then the 8 warps' aggregates in
// shared memory) gives each thread the sum of the row that is open at its
// first item, and one running sum carries the open row from tile to tile.
// The thread whose items end a row writes it: into Y, or, for the span's
// first and last rows, into the carries, which keep K2's layout. Each row
// is written once by one thread, with no atomics, so K4 is deterministic.
// Its bound is the plan's stream, 12 B per item (col, val, seg) plus X
// and Y, against the function's 8 B per nonzero and 4 B per row. Where
// columns are random (hhh_like), each x load fetches a 32-byte L2 sector
// for 4 bytes, and those gathers, not the plan's stream, take most of
// K4's time. Trial builds on the H100 (PERF.md) were no faster
// with 2 or 8 items a thread, 128- or 512-thread blocks, or fewer
// registers for more blocks an SM.
//
// Padding: the plan pads each span to D items with seg == 0, val == 0,
// col == 0. Only the first span_len[p] items are read, so the drop back to
// seg == 0 never opens a new row.
//
// The carry step's design. Its work is tiny (2P carries of k floats) but
// it sits after every merge multiply, so what it costs is latency: a host
// call, a launch, and the longest run of carries that name one row (the
// mawi dense row crosses hundreds of spans). So:
// * one host call per multiply: merge_spmv_launch / merge_spmm_launch
//   issue the memset of Y, the partials kernel and the fix-up on the
//   caller's stream, with Y and the carries in one allocation;
// * the fix-up is launched with programmatic dependent launch: every
//   partials block lets it launch as it starts
//   (cudaTriggerProgrammaticLaunchCompletion), so its launch and block
//   scheduling overlap the partials' last wave, and it waits in
//   cudaGridDependencySynchronize() before it reads anything. The
//   partials kernels write a span's first and last rows only to the
//   carries, never to Y, so the fix-up's += into Y races with nothing;
// * one warp per carry entry; the warp at the head of a run of entries
//   that name one row (-1 entries skipped) sums the run. It first finds
//   the run's end from the rows alone (a ballot over the 32 entries from
//   e, then 256 a round). A pass of up to 32 columns gives each column kc
//   lanes (the least power of two >= the pass's width) and the 32 / kc
//   lane slots split the run's entries (its i-th entry to slot
//   i % (32 / kc)); every lane sums its entries in span order (its
//   first 2 loaded with the rows, then up to 32 a round with all their
//   loads in flight), and a fixed xor butterfly adds the slots. At k >= 32 (kc = 32) the lanes take the columns and each
//   column is summed in span order with coalesced loads; at k = 1 the 32
//   lanes split a long run, so the dense row costs a warp's parallel
//   loads, not a chain of dependent ones. The standalone carry_out_fixup
//   entry launches the same kernel, so both paths give the same bits; no
//   atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGather = 4;        // X rows a chain has in flight

// The columns of one K2 lane: L = 4, four as float4 loads and stores
// (k % 4 == 0); L = 5, four as scalars at any alignment (k % 4 != 0,
// k > 32: one pass where one column a lane would take two); L = 1, one.
// nv is the number of the lane's columns below k.
template <int L> struct Vec;
template <> struct Vec<4> {
  using T = float4;
  static constexpr int kCols = 4;
  __device__ __forceinline__ static T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ static T load(const float* p, int) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void fma(float v, const T& x, T& a) {
    a.x = fmaf(v, x.x, a.x);
    a.y = fmaf(v, x.y, a.y);
    a.z = fmaf(v, x.z, a.z);
    a.w = fmaf(v, x.w, a.w);
  }
  __device__ __forceinline__ static void store(float* p, const T& a, int) {
    *reinterpret_cast<float4*>(p) = a;
  }
  __device__ __forceinline__ static void put(float* p, const T& a) {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
    p[3] = a.w;
  }
};
template <> struct Vec<5> : Vec<4> {
  __device__ __forceinline__ static T load(const float* p, int nv) {
    T v = zero();
    v.x = __ldg(p);
    if (nv > 1) v.y = __ldg(p + 1);
    if (nv > 2) v.z = __ldg(p + 2);
    if (nv > 3) v.w = __ldg(p + 3);
    return v;
  }
  __device__ __forceinline__ static void store(float* p, const T& a,
                                               int nv) {
    p[0] = a.x;
    if (nv > 1) p[1] = a.y;
    if (nv > 2) p[2] = a.z;
    if (nv > 3) p[3] = a.w;
  }
};
template <> struct Vec<1> {
  using T = float;
  static constexpr int kCols = 1;
  __device__ __forceinline__ static T zero() { return 0.f; }
  __device__ __forceinline__ static T load(const float* p, int) {
    return __ldg(p);
  }
  __device__ __forceinline__ static void fma(float v, const T& x, T& a) {
    a = fmaf(v, x, a);
  }
  __device__ __forceinline__ static void store(float* p, const T& a, int) {
    *p = a;
  }
  __device__ __forceinline__ static void put(float* p, const T& a) {
    *p = a;
  }
};

template <int S, int LAYOUT>
__global__ void __launch_bounds__(kThreads)
merge_partials_kernel(const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int* __restrict__ seg,
                      const int* __restrict__ row_starts,
                      const int* __restrict__ span_len,
                      const float* __restrict__ x, float* __restrict__ y,
                      int* __restrict__ carry_row,
                      float* __restrict__ carry_val, int D, int k) {
  using V = Vec<LAYOUT>;
  constexpr int VEC = V::kCols;
  constexpr int NC = kThreads / S;            // chains
  constexpr int CP = S * VEC;                 // columns a pass
  constexpr int R = 32 / S < 4 ? 32 / S : 4;  // items a lane stages
  constexpr int CH = S * R;                   // items a chain stages
  __shared__ int s_row[2 * NC];
  __shared__ int s_list[2 * NC];
  __shared__ int s_n;
  __shared__ __align__(16) float s_val[2 * NC * CP];
  // a carry fix-up launched after this grid may start scheduling its
  // blocks once every block of this one has started (it waits for this
  // grid to finish before it reads a carry)
  cudaTriggerProgrammaticLaunchCompletion();
  const int p = blockIdx.x;
  const int ch = threadIdx.x / S, li = threadIdx.x % S;
  const int lane = threadIdx.x & 31;
  const int len = span_len[p];
  const long long r0 = row_starts[p];
  const long long base = (long long)p * D;
  const int L = (len + NC - 1) / NC;          // items a chain
  const int a = min(ch * L, len), b = min(a + L, len);
  const int rounds = (L + CH - 1) / CH;       // the same for every chain

  for (int j0 = 0; j0 < k; j0 += CP) {
    const int jl = j0 + li * VEC;             // the lane's first column
    const bool active = jl < k;
    const int ncols = min(VEC, k - jl);     // of them below k
    int cur = -1, first_row = -1;
    typename V::T acc = V::zero(), first_val = V::zero();
    // the chain's next CH items, lane li holding items li + S * r: one
    // coalesced load per array and r for the S lanes
    int nc[R], ns[R];
    float nv[R];
    auto stage = [&](int i0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r * S + li;
        const bool ok = i < b;
        nc[r] = ok ? __ldg(cols + base + i) : 0;
        nv[r] = ok ? __ldg(vals + base + i) : 0.f;
        ns[r] = ok ? __ldg(seg + base + i) : -1;
      }
    };
    stage(a);
    for (int rd = 0; rd < rounds; ++rd) {
      int cc[R], cs[R];
      float cv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cc[r] = nc[r];
        cs[r] = ns[r];
        cv[r] = nv[r];
      }
      if (rd + 1 < rounds) stage(a + (rd + 1) * CH);   // in flight below
#pragma unroll
      for (int g0 = 0; g0 < CH; g0 += kGather) {
        int col[kGather], sg[kGather];
        float v[kGather];
        typename V::T xv[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u) {   // item g0 + u of the chunk
          const int t = g0 + u;
          col[u] = __shfl_sync(kFull, cc[t / S], t % S, S);
          sg[u] = __shfl_sync(kFull, cs[t / S], t % S, S);
          v[u] = __shfl_sync(kFull, cv[t / S], t % S, S);
        }
        // every gather of the group is issued before the first FMA
#pragma unroll
        for (int u = 0; u < kGather; ++u)
          xv[u] = (sg[u] >= 0 && active)
                      ? V::load(x + (long long)col[u] * k + jl, ncols)
                      : V::zero();
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          if (sg[u] < 0) continue;
          if (sg[u] != cur) {
            if (cur >= 0) {
              if (first_row < 0) {
                first_row = cur;
                first_val = acc;
              } else if (active) {
                V::store(y + (r0 + cur) * k + jl, acc, ncols);
              }
            }
            cur = sg[u];
            acc = V::zero();
          }
          V::fma(v[u], xv[u], acc);
        }
      }
    }
    // the chain's first and last rows go to shared memory (last -1 when
    // the chain saw one row, both -1 when it saw none)
    const bool one = first_row < 0;
    if (li == 0) {
      s_row[2 * ch] = one ? cur : first_row;
      s_row[2 * ch + 1] = one ? -1 : cur;
    }
    V::put(s_val + (2 * ch) * CP + li * VEC, one ? acc : first_val);
    V::put(s_val + (2 * ch + 1) * CP + li * VEC, one ? V::zero() : acc);
    __syncthreads();
    // the entries that name a row, in order
    if (threadIdx.x < 32) {
      int n = 0;
      for (int e0 = 0; e0 < 2 * NC; e0 += 32) {
        const int e = e0 + lane;
        const bool ok = e < 2 * NC && s_row[e] >= 0;
        const unsigned bal = __ballot_sync(kFull, ok);
        if (ok) s_list[n + __popc(bal & ((1u << lane) - 1u))] = e;
        n += __popc(bal);
      }
      if (lane == 0) s_n = n;
    }
    __syncthreads();
    // the head of each run of equal rows sums the run in chain order, per
    // column: the span's first and last rows go to the carries, the
    // others (wholly inside the span) into Y
    const int n = s_n;
    const int first = n > 0 ? s_row[s_list[0]] : -1;
    const int last = n > 0 ? s_row[s_list[n - 1]] : -1;
    for (int task = threadIdx.x; task < n * CP; task += kThreads) {
      const int qi = task / CP, c = task - qi * CP;
      const int j = j0 + c;
      const int r = s_row[s_list[qi]];
      if (j >= k || (qi > 0 && s_row[s_list[qi - 1]] == r)) continue;
      float sum = s_val[s_list[qi] * CP + c];
      for (int q2 = qi + 1; q2 < n && s_row[s_list[q2]] == r; ++q2)
        sum += s_val[s_list[q2] * CP + c];
      if (r == first)
        carry_val[(2LL * p) * k + j] = sum;
      else if (r == last)
        carry_val[(2LL * p + 1) * k + j] = sum;
      else
        y[(r0 + r) * k + j] = sum;
    }
    for (int c = threadIdx.x; c < CP && j0 + c < k; c += kThreads) {
      if (n == 0) carry_val[(2LL * p) * k + j0 + c] = 0.f;
      if (last == first) carry_val[(2LL * p + 1) * k + j0 + c] = 0.f;
    }
    if (j0 == 0 && threadIdx.x == 0) {
      carry_row[2 * p] = n > 0 ? (int)(r0 + first) : -1;
      carry_row[2 * p + 1] = n > 0 && last != first ? (int)(r0 + last) : -1;
    }
    __syncthreads();                  // the entries are rewritten next pass
  }
}

// ------------------------------------------------------------ carry ----
constexpr int kFixWarps = 8;                   // warps (carry entries) a block
constexpr int kFixFirst = 2;                   // entries a lane loads at once
constexpr int kFixScan = 8;                    // rows a lane scans a round
constexpr int kFixLoads = 32;                  // entries a lane sums a round

// A pass of the carry step over columns j0 .. j0 + w - 1 (w <= 32): each
// column has kc = 1 << lg lanes (the least power of two >= w) and the
// S = 32 / kc lane slots take the run's entries in turn; a lane past the
// pass's width reads column j0 and writes nothing.
struct FixPass {
  int w, lg, S, s, c;
  long long cj;
  __device__ FixPass(int j0, int k, int lane) {
    w = min(32, k - j0);
    lg = 0;
    while ((1 << lg) < w) ++lg;
    S = 32 >> lg;
    s = lane >> lg;
    c = lane & ((1 << lg) - 1);
    cj = (long long)j0 + (c < w ? c : 0);
  }
};

// The lane's entries f0 + s + u S (u < U) of a pass: rows and values,
// every load issued before any is used (an entry past the last reads the
// last: the adds mask it). L2 loads (ld.cg): the carries were written by
// the grid this one may have overlapped.
template <int U>
__device__ __forceinline__ void fix_load(
    const int* __restrict__ carry_row, const float* __restrict__ carry_val,
    int n, int k, const FixPass& ps, int f0, int* rf, float* v) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int f = min(f0 + u * ps.S + ps.s, n - 1);
    rf[u] = __ldcg(carry_row + f);
    v[u] = __ldcg(carry_val + (long long)f * k + ps.cj);
  }
}

// Adds the loaded entries of the run (before end, naming row r) to sum in
// order. The others add +0: a select, not a branch, so that no load is
// sunk into a branch and made to wait for the one before.
template <int U>
__device__ __forceinline__ float fix_add(const FixPass& ps, int f0, int end,
                                         int r, const int* rf,
                                         const float* v, float sum) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = f0 + u * ps.S + ps.s < end && rf[u] == r;
    sum += in ? v[u] : 0.f;
  }
  return sum;
}

// Entry e's warp: if e heads a run of entries that name one row, add the
// run's sum into that row of y (see the header). Warp-uniform throughout.
// A run of up to 2 S entries costs two dependent rounds of loads: the
// rows around e (is e a head, where does its run end) with the run's
// first values, then y's row.
__device__ __forceinline__ void carry_fixup_warp(
    const int* __restrict__ carry_row, const float* __restrict__ carry_val,
    float* __restrict__ y, int n, int k, int e) {
  const int lane = threadIdx.x & 31;
  auto row_at = [&](int f) { return f < n ? __ldcg(carry_row + f) : -2; };
  const int r = __ldcg(carry_row + e);
  int rq = e - 1 - lane >= 0 ? __ldcg(carry_row + e - 1 - lane) : -1;
  const int rn = row_at(e + lane);             // -2: past the last entry
  FixPass ps(0, k, lane);
  int rf[kFixLoads];
  float v[kFixLoads];
  fix_load<kFixFirst>(carry_row, carry_val, n, k, ps, e, rf, v);
  if (r < 0) return;
  // the nearest entry before e that names a row decides the head
  for (int q0 = e - 1;;) {
    const unsigned named = __ballot_sync(kFull, rq >= 0);
    if (named) {
      if (__shfl_sync(kFull, rq, __ffs(named) - 1) == r) return;
      break;
    }
    q0 -= 32;
    if (q0 < 0) break;
    rq = q0 - lane >= 0 ? __ldcg(carry_row + q0 - lane) : -1;
  }
  // the run ends at the first entry after e that names another row
  unsigned other = __ballot_sync(kFull, rn != r && rn != -1);
  int end = e + __ffs(other) - 1;
  for (int f0 = e + 32; !other; f0 += 32 * kFixScan) {
    int rr[kFixScan];
#pragma unroll
    for (int u = 0; u < kFixScan; ++u) rr[u] = row_at(f0 + u * 32 + lane);
#pragma unroll
    for (int u = 0; u < kFixScan; ++u) {
      const unsigned b = __ballot_sync(kFull, rr[u] != r && rr[u] != -1);
      if (b && !other) {
        other = b;
        end = f0 + u * 32 + __ffs(b) - 1;
      }
    }
  }
  for (int j0 = 0; j0 < k; j0 += 32) {
    if (j0 > 0) {
      ps = FixPass(j0, k, lane);
      fix_load<kFixFirst>(carry_row, carry_val, n, k, ps, e, rf, v);
    }
    const bool out = ps.s == 0 && ps.c < ps.w;   // the lane that writes
    float* yp = y + (long long)r * k + ps.cj;
    const float y0 = out ? *yp : 0.f;
    // each lane sums its slot's entries e + s, e + s + S, ... in span
    // order: the first kFixFirst, then kFixLoads a round
    float sum = fix_add<kFixFirst>(ps, e, end, r, rf, v, 0.f);
    for (int f0 = e + kFixFirst * ps.S; f0 < end; f0 += kFixLoads * ps.S) {
      fix_load<kFixLoads>(carry_row, carry_val, n, k, ps, f0, rf, v);
      sum = fix_add<kFixLoads>(ps, f0, end, r, rf, v, sum);
    }
    // the slots' sums, in a fixed order (every lane of a column ends with
    // the same bits: each add has the same two operands)
    for (int off = 1 << ps.lg; off < 32; off <<= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (out) *yp = y0 + sum;
  }
}

// A block takes kFixWarps entries, a warp each. A minimum of one block an
// SM lets ptxas give a thread the registers to hold a round's 64 loaded
// values at once; under its default budget it interleaves the loads with
// the adds, and a long run's loads wait for one another.
__global__ void __launch_bounds__(kFixWarps * 32, 1)
merge_carry_fixup_kernel(const int* __restrict__ carry_row,
                         const float* __restrict__ carry_val,
                         float* __restrict__ y, int n, int k) {
  // launched as a programmatic dependent of the partials kernel: wait for
  // its carries (returns at once after an ordinary launch)
  cudaGridDependencySynchronize();
  const int e = blockIdx.x * kFixWarps + (threadIdx.x >> 5);
  if (e < n) carry_fixup_warp(carry_row, carry_val, y, n, k, e);
}

// The fix-up over n entries on stream s; pdl: as a programmatic dependent
// of the kernel before it in the stream.
int launch_fixup(const int* carry_row, const float* carry_val, float* y,
                 int n, int k, cudaStream_t s, bool pdl) {
  if (n <= 0 || k <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + kFixWarps - 1) / kFixWarps));
  cfg.blockDim = dim3(kFixWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, merge_carry_fixup_kernel, carry_row,
                                 carry_val, y, n, k);
}

template <int S, int L>
void launch_partials_sv(const int* cols, const float* vals, const int* seg,
                        const int* row_starts, const int* span_len,
                        const float* x, float* y, int* carry_row,
                        float* carry_val, int P, int D, int k,
                        cudaStream_t s) {
  merge_partials_kernel<S, L><<<P, kThreads, 0, s>>>(
      cols, vals, seg, row_starts, span_len, x, y, carry_row, carry_val, D,
      k);
}

int launch_partials(const int* cols, const float* vals, const int* seg,
                    const int* row_starts, const int* span_len,
                    const float* x, float* y, int* carry_row,
                    float* carry_val, int P, int D, int k, void* stream) {
  if (P <= 0 || k <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // lanes a chain: enough for the row (4 columns a lane where k % 4 == 0
  // or k > 32, else 1), at least 2 and at most 32; wider k takes passes
  const int L = k % 4 == 0 ? 4 : (k > 32 ? 5 : 1);
  const int need = L == 1 ? k : (k + 3) / 4;
  int S = 2;
  while (S < need && S < 32) S <<= 1;
#define REPRO_K2(SV, LV)                                                    \
  if (S == SV && L == LV)                                                   \
    launch_partials_sv<SV, LV>(cols, vals, seg, row_starts, span_len, x, y, \
                               carry_row, carry_val, P, D, k, s);
  REPRO_K2(2, 1) REPRO_K2(4, 1) REPRO_K2(8, 1) REPRO_K2(16, 1)
  REPRO_K2(32, 1) REPRO_K2(2, 4) REPRO_K2(4, 4) REPRO_K2(8, 4)
  REPRO_K2(16, 4) REPRO_K2(32, 4) REPRO_K2(16, 5) REPRO_K2(32, 5)
#undef REPRO_K2
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K4 ----
constexpr int kSpmvThreads = 256;
constexpr int kSpmvItems = 4;                  // consecutive items a thread
constexpr int kSpmvWarps = kSpmvThreads / 32;
constexpr int kWarpItems = 32 * kSpmvItems;
constexpr int kTileItems = kSpmvThreads * kSpmvItems;

// shared-memory slot of a warp's item i: one word of skew every 32, so
// the transposed reads (lane * kSpmvItems + v) meet no bank twice
__host__ __device__ constexpr int skewed(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(kSpmvThreads)
merge_spmv_kernel(const int* __restrict__ cols,
                  const float* __restrict__ vals,
                  const int* __restrict__ seg,
                  const int* __restrict__ row_starts,
                  const int* __restrict__ span_len,
                  const float* __restrict__ x, float* __restrict__ y,
                  int* __restrict__ carry_row,
                  float* __restrict__ carry_val, int D) {
  constexpr int kSlots = skewed(kWarpItems - 1) + 1;
  __shared__ int s_col[kSpmvWarps][kSlots];
  __shared__ float s_val[kSpmvWarps][kSlots];
  __shared__ int s_seg[kSpmvWarps][kSlots];
  // per warp of a tile (two tiles alternate): does a row start in it, and
  // the sum since its last row start (its whole sum when none starts)
  __shared__ int s_flag[2][kSpmvWarps];
  __shared__ float s_sum[2][kSpmvWarps];
  cudaTriggerProgrammaticLaunchCompletion();     // as in K2
  const int p = blockIdx.x;
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = span_len[p];
  const long long base = (long long)p * D;
  const long long r0 = row_starts[p];
  const int first = len > 0 ? seg[base] : -1;      // the span's first row
  const int last = len > 0 ? seg[base + len - 1] : -1;

  // the warp's items of the tile at tb, striped (register v holds item
  // w0 + 32 v + lane; seg -1 past the span), and for lane 0 the row of the
  // item just before the warp's first (-1 at the span start)
  int nc[kSpmvItems], ns[kSpmvItems];
  float nv[kSpmvItems];
  int nprev = -1;
  auto fetch = [&](int tb) {
    const int w0 = tb + wi * kWarpItems;
#pragma unroll
    for (int v = 0; v < kSpmvItems; ++v) {
      const int i = w0 + v * 32 + lane;
      const bool ok = i < len;
      nc[v] = ok ? __ldg(cols + base + i) : 0;
      nv[v] = ok ? __ldg(vals + base + i) : 0.f;
      ns[v] = ok ? __ldg(seg + base + i) : -1;
    }
    nprev = lane == 0 && w0 > 0 && w0 <= len ? __ldg(seg + base + w0 - 1)
                                             : -1;
  };

  float carry = 0.f;   // the open row's sum over the tiles before
  int buf = 0;
  fetch(0);
  for (int tb = 0; tb < len; tb += kTileItems, buf ^= 1) {
    // striped -> blocked: thread item v is tile item lane * 4 + v of the
    // warp's 128
#pragma unroll
    for (int v = 0; v < kSpmvItems; ++v) {
      const int j = skewed(v * 32 + lane);
      s_col[wi][j] = nc[v];
      s_val[wi][j] = nv[v];
      s_seg[wi][j] = ns[v];
    }
    int prev = nprev;
    __syncwarp();
    int key[kSpmvItems], col[kSpmvItems];
    float prod[kSpmvItems];
#pragma unroll
    for (int v = 0; v < kSpmvItems; ++v) {
      const int j = skewed(lane * kSpmvItems + v);
      key[v] = s_seg[wi][j];
      prod[v] = s_val[wi][j];
      col[v] = s_col[wi][j];
    }
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kSpmvItems; ++v)
      prod[v] = key[v] >= 0 ? prod[v] * __ldg(x + col[v]) : 0.f;
    // the next tile's loads are in flight while this one is reduced
    if (tb + kTileItems < len) fetch(tb + kTileItems);

    // the row of the item before this thread's first
    const int up = __shfl_up_sync(kFull, key[kSpmvItems - 1], 1);
    if (lane > 0) prev = up;

    // this thread's (flag, sum since its last row start)
    int f = 0;
    float a = 0.f;
    {
      int k = prev;
#pragma unroll
      for (int v = 0; v < kSpmvItems; ++v) {
        if (key[v] < 0) continue;
        if (key[v] != k) {
          f = 1;
          a = 0.f;
        }
        a += prod[v];
        k = key[v];
      }
    }
    // inclusive segmented scan over the warp: (f1, a1) then (f2, a2) is
    // (f1 | f2, f2 ? a2 : a1 + a2)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a2 = __shfl_up_sync(kFull, a, off);
      const int f2 = __shfl_up_sync(kFull, f, off);
      if (lane >= off) {
        a = f ? a : a2 + a;
        f |= f2;
      }
    }
    float ea = __shfl_up_sync(kFull, a, 1);
    int ef = __shfl_up_sync(kFull, f, 1);
    if (lane == 0) {
      ea = 0.f;
      ef = 0;
    }
    if (lane == 31) {
      s_flag[buf][wi] = f;
      s_sum[buf][wi] = a;
    }
    __syncthreads();
    // the open row's sum before this warp, and after the whole tile
    float before = 0.f, open = carry;
#pragma unroll
    for (int w = 0; w < kSpmvWarps; ++w) {
      if (w == wi) before = open;
      open = s_flag[buf][w] ? s_sum[buf][w] : open + s_sum[buf][w];
    }
    carry = open;

    // walk the items again from the open row's sum: a row change closes
    // the row before it, whose sum is complete
    float run = ef ? ea : before + ea;
    int cur = prev;
#pragma unroll
    for (int v = 0; v < kSpmvItems; ++v) {
      if (key[v] < 0) continue;
      if (key[v] != cur) {
        if (cur >= 0) {
          if (cur == first)
            carry_val[2LL * p] = run;
          else
            y[r0 + cur] = run;
        }
        cur = key[v];
        run = 0.f;
      }
      run += prod[v];
    }
  }

  // the span's last row is still open: it goes to the carries, with the
  // first row's id (the first row's sum went there when it closed)
  if (threadIdx.x == 0) {
    const bool two = len > 0 && last != first;
    carry_row[2LL * p] = len > 0 ? (int)(r0 + first) : -1;
    carry_row[2LL * p + 1] = two ? (int)(r0 + last) : -1;
    if (two) {
      carry_val[2LL * p + 1] = carry;
    } else {
      carry_val[2LL * p] = carry;                // 0 for an empty span
      carry_val[2LL * p + 1] = 0.f;
    }
  }
}

// The one allocation of a merge multiply: y f32[m, k], then carry_row
// i32[2P], then carry_val f32[2P, k] (`merge_out_views` in
// kernels/merge_spmv.py cuts the same views).
struct MergeOut {
  float* y;
  int* carry_row;
  float* carry_val;
  MergeOut(float* out, long long m, int k, int P)
      : y(out), carry_row(reinterpret_cast<int*>(out + m * k)),
        carry_val(out + m * k + 2LL * P) {}
};

// K2 on one stream: the memset of y, the partials kernel and, with fix,
// the carry step as its programmatic dependent.
int issue_spmm(const int* cols, const float* vals, const int* seg,
               const int* row_starts, const int* span_len, const float* x,
               float* out, int P, int D, long long m, int k, void* stream,
               bool fix) {
  cudaStream_t s = (cudaStream_t)stream;
  const MergeOut o(out, m, k, P);
  const cudaError_t e =
      cudaMemsetAsync(o.y, 0, (size_t)m * k * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  const int rc = launch_partials(cols, vals, seg, row_starts, span_len, x,
                                 o.y, o.carry_row, o.carry_val, P, D, k,
                                 stream);
  if (rc != 0 || !fix || P <= 0) return rc;
  return launch_fixup(o.carry_row, o.carry_val, o.y, 2 * P, k, s, true);
}

// K4 likewise (k = 1).
int issue_spmv(const int* cols, const float* vals, const int* seg,
               const int* row_starts, const int* span_len, const float* x,
               float* out, int P, int D, long long m, void* stream,
               bool fix) {
  cudaStream_t s = (cudaStream_t)stream;
  const MergeOut o(out, m, 1, P);
  const cudaError_t e = cudaMemsetAsync(o.y, 0, (size_t)m * sizeof(float),
                                        s);
  if (e != cudaSuccess || P <= 0) return (int)e;
  merge_spmv_kernel<<<P, kSpmvThreads, 0, s>>>(
      cols, vals, seg, row_starts, span_len, x, o.y, o.carry_row,
      o.carry_val, D);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || !fix) return rc;
  return launch_fixup(o.carry_row, o.carry_val, o.y, 2 * P, 1, s, true);
}

}  // namespace

extern "C" {

// Plan arrays cols/vals/seg [P, D], row_starts i32[P+1], span_len i32[P];
// x f32[n, k]; out the one allocation (MergeOut) of m * k + 2P (k + 1)
// floats: y is zeroed here (rows with no item are never written), the
// carries are fully written. Returns the first CUDA error.
int merge_spmm_partials_launch(const int* cols, const float* vals,
                               const int* seg, const int* row_starts,
                               const int* span_len, const float* x,
                               float* out, int P, int D, long long m, int k,
                               void* stream) {
  return issue_spmm(cols, vals, seg, row_starts, span_len, x, out, P, D, m,
                    k, stream, false);
}

// The whole merge SpMM, K2 and the carry step, from one host call: out as
// above, y holds A x on return (in stream order).
int merge_spmm_launch(const int* cols, const float* vals, const int* seg,
                      const int* row_starts, const int* span_len,
                      const float* x, float* out, int P, int D, long long m,
                      int k, void* stream) {
  return issue_spmm(cols, vals, seg, row_starts, span_len, x, out, P, D, m,
                    k, stream, true);
}

// K4, the k = 1 entry: the same arrays, x f32[n], out of m + 4P floats.
int merge_spmv_partials_launch(const int* cols, const float* vals,
                               const int* seg, const int* row_starts,
                               const int* span_len, const float* x,
                               float* out, int P, int D, long long m,
                               void* stream) {
  return issue_spmv(cols, vals, seg, row_starts, span_len, x, out, P, D, m,
                    stream, false);
}

// The whole merge SpMV, K4 and the carry step, from one host call.
int merge_spmv_launch(const int* cols, const float* vals, const int* seg,
                      const int* row_starts, const int* span_len,
                      const float* x, float* out, int P, int D, long long m,
                      void* stream) {
  return issue_spmv(cols, vals, seg, row_starts, span_len, x, out, P, D, m,
                    stream, true);
}

// The standalone carry step: carry_row i32[n_entries], carry_val
// f32[n_entries, k], y f32[m, k] (an ordinary launch of the same kernel).
int merge_carry_fixup_launch(const int* carry_row, const float* carry_val,
                             float* y, int n_entries, int k, void* stream) {
  return launch_fixup(carry_row, carry_val, y, n_entries, k,
                      (cudaStream_t)stream, false);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
