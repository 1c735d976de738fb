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
// Design. One block of 256 threads per span p. The threads form G groups
// of kt = min(pow2ceil(k), 32) threads; a group takes a contiguous share
// of the span's items and its threads take kt consecutive columns (a warp
// reads one X row segment when k >= 32). Each group runs a sequential
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

// The k = 1 entry (K4): x f32[n], y f32[m], carry_val f32[2P].
int merge_spmv_partials_launch(const int* cols, const float* vals,
                               const int* seg, const int* row_starts,
                               const int* span_len, const float* x, float* y,
                               int* carry_row, float* carry_val, int P, int D,
                               void* stream) {
  return launch_partials(cols, vals, seg, row_starts, span_len, x, y,
                         carry_row, carry_val, P, D, 1, stream);
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
