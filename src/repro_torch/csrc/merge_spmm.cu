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
// K2's design. One block of 256 threads per span p. The threads form G
// groups of kt = min(pow2ceil(k), 32) threads; a group takes a contiguous
// share of the span's items and its threads take kt consecutive columns (a
// warp reads one X row segment when k >= 32). Each group runs a sequential
// segmented sum over its share: a row whose items all lie inside the share
// is written straight into Y; the share's first and last rows go to shared
// memory. One thread per column then walks the 2G shared entries in order
// and merges equal rows: rows inside the span are written into Y, and the
// span's own first and last rows — the only rows a neighbouring span can
// share — go to the [P, 2, k] carry buffer with their global row ids (-1
// for none). The carry kernel then adds, for each row, all carries naming
// it in span order (the mawi dense row crosses many spans) and adds the sum
// into Y. Every row is written by exactly one thread exactly once, so Y is
// deterministic and needs no atomics; Y must start zeroed (rows with no
// items are never written).
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_partials_kernel(const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const int* __restrict__ seg,
                      const int* __restrict__ row_starts,
                      const int* __restrict__ span_len,
                      const float* __restrict__ x, float* __restrict__ y,
                      int* __restrict__ carry_row,
                      float* __restrict__ carry_val, int D, int k, int kt) {
  __shared__ int s_row[2 * kThreads];
  __shared__ float s_val[2 * kThreads];
  const int p = blockIdx.x;
  const int G = kThreads / kt;
  const int g = threadIdx.x / kt;
  const int c = threadIdx.x - g * kt;
  const int len = span_len[p];
  const long long r0 = row_starts[p];
  const long long base = (long long)p * D;
  const int L = (len + G - 1) / G;
  const int a = min(g * L, len);
  const int b = min(a + L, len);

  for (int j0 = 0; j0 < k; j0 += kt) {
    const int j = j0 + c;
    const bool active = j < k;
    int first_row = -1, last_row = -1;
    float first_val = 0.f, last_val = 0.f;
    if (a < b) {
      int cur = seg[base + a];
      float acc = 0.f;
      bool is_first = true;
      for (int i = a; i < b; ++i) {
        const int s = seg[base + i];
        if (s != cur) {
          if (is_first) {
            first_row = cur;
            first_val = acc;
            is_first = false;
          } else if (active) {
            y[(r0 + cur) * k + j] = acc;
          }
          cur = s;
          acc = 0.f;
        }
        if (active)
          acc = fmaf(vals[base + i], x[(long long)cols[base + i] * k + j],
                     acc);
      }
      if (is_first) {
        first_row = cur;
        first_val = acc;
      } else {
        last_row = cur;
        last_val = acc;
      }
    }
    if (c == 0) {
      s_row[2 * g] = first_row;
      s_row[2 * g + 1] = last_row;
    }
    s_val[(2 * g) * kt + c] = first_val;
    s_val[(2 * g + 1) * kt + c] = last_val;
    __syncthreads();

    if (threadIdx.x < kt) {
      int run_row = -1, span_first = -1, span_last = -1;
      float run = 0.f, v_first = 0.f, v_last = 0.f;
      for (int e = 0; e < 2 * G; ++e) {
        const int r = s_row[e];
        if (r < 0) continue;
        const float v = s_val[e * kt + c];
        if (r == run_row) {
          run += v;
          continue;
        }
        if (run_row >= 0) {
          if (span_first < 0) {
            span_first = run_row;
            v_first = run;
          } else if (active) {
            y[(r0 + run_row) * k + j] = run;
          }
        }
        run_row = r;
        run = v;
      }
      if (run_row >= 0) {
        if (span_first < 0) {
          span_first = run_row;
          v_first = run;
        } else {
          span_last = run_row;
          v_last = run;
        }
      }
      if (j0 == 0 && c == 0) {
        carry_row[2 * p] = span_first >= 0 ? (int)(r0 + span_first) : -1;
        carry_row[2 * p + 1] = span_last >= 0 ? (int)(r0 + span_last) : -1;
      }
      if (active) {
        carry_val[(2LL * p) * k + j] = v_first;
        carry_val[(2LL * p + 1) * k + j] = v_last;
      }
    }
    __syncthreads();
  }
}

// One thread per (carry entry, column). The thread at the head of a run of
// entries naming the same row sums the run in span order and adds it into
// Y; every other thread returns. Entries with row -1 are skipped.
__global__ void merge_carry_fixup_kernel(const int* __restrict__ carry_row,
                                         const float* __restrict__ carry_val,
                                         float* __restrict__ y,
                                         int n_entries, int k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_entries * k) return;
  const int e = (int)(t / k);
  const int j = (int)(t - (long long)e * k);
  const int r = carry_row[e];
  if (r < 0) return;
  int q = e - 1;
  while (q >= 0 && carry_row[q] < 0) --q;
  if (q >= 0 && carry_row[q] == r) return;       // not the head of its run
  float sum = 0.f;
  for (int f = e; f < n_entries; ++f) {
    const int rf = carry_row[f];
    if (rf < 0) continue;
    if (rf != r) break;
    sum += carry_val[(long long)f * k + j];
  }
  y[(long long)r * k + j] += sum;
}

int column_tile(int k) {
  int kt = 1;
  while (kt < k && kt < 32) kt <<= 1;
  return kt;
}

int launch_partials(const int* cols, const float* vals, const int* seg,
                    const int* row_starts, const int* span_len,
                    const float* x, float* y, int* carry_row,
                    float* carry_val, int P, int D, int k, void* stream) {
  if (P <= 0 || k <= 0) return 0;
  merge_partials_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(
      cols, vals, seg, row_starts, span_len, x, y, carry_row, carry_val,
      D, k, column_tile(k));
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

constexpr unsigned kFull = 0xffffffffu;

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

}  // namespace

extern "C" {

// Plan arrays cols/vals/seg [P, D], row_starts i32[P+1], span_len i32[P];
// x f32[n, k]; y f32[m, k] zeroed by the caller; carry_row i32[2P] and
// carry_val f32[2P, k] fully written. Returns cudaGetLastError().
int merge_spmm_partials_launch(const int* cols, const float* vals,
                               const int* seg, const int* row_starts,
                               const int* span_len, const float* x, float* y,
                               int* carry_row, float* carry_val, int P, int D,
                               int k, void* stream) {
  return launch_partials(cols, vals, seg, row_starts, span_len, x, y,
                         carry_row, carry_val, P, D, k, stream);
}

// K4, the k = 1 entry: the same arrays, x f32[n], y f32[m], zeroed here
// (rows with no item are never written), carry_row i32[2P] and carry_val
// f32[2P] fully written. Returns cudaGetLastError().
int merge_spmv_partials_launch(const int* cols, const float* vals,
                               const int* seg, const int* row_starts,
                               const int* span_len, const float* x, float* y,
                               int* carry_row, float* carry_val, int P, int D,
                               long long m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(y, 0, (size_t)m * sizeof(float), s);
  if (e != cudaSuccess || P <= 0) return (int)e;
  merge_spmv_kernel<<<P, kSpmvThreads, 0, s>>>(
      cols, vals, seg, row_starts, span_len, x, y, carry_row, carry_val, D);
  return (int)cudaGetLastError();
}

// carry_row i32[n_entries], carry_val f32[n_entries, k], y f32[m, k].
int merge_carry_fixup_launch(const int* carry_row, const float* carry_val,
                             float* y, int n_entries, int k, void* stream) {
  if (n_entries <= 0 || k <= 0) return 0;
  const long long total = (long long)n_entries * k;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  merge_carry_fixup_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(carry_row, carry_val, y,
                                                     n_entries, k);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
