// The run-and-bucket body of the one-hot window products: K7 (x (n,)) and
// K8 (X (n, B)) on the flat grid.  Templated on the tile map like the bodies
// of window_kernels.cuh, so the rectangular grid (RectTiles) can take it too.
//
// Per k-step of S slots the TPU body contracts (S, W) one-hot masks of the
// slots' rows and columns:
//
//   win = oh_rows^T · (vl * x[col])  +  oh_cols^T · (vu * x[row])
//
// so window position w receives the row-side products of the slots whose
// row is w, then the column-side products of the slots whose column is w.
// Each position meets few of the S slots, so the body indexes the staged
// step instead of scanning it:
//
//   row side     a step's rows never decrease (slots are row-major; checked
//                wherever a pack is built, loaded or converted), so row w's
//                slots are one run [lo, hi); the slots that open and close
//                a run write its bounds;
//   column side  a stable counting sort of the step's slots by column gives
//                column w its bucket of slots, in slot order.
//
// Position w sums its run in slot order, then its bucket in slot order, and
// adds the two sums — the TPU body's two contractions, added.  Products are
// rounded before they are summed (__fmul_rn: never fused into an add), as
// the body forms them.  The result window starts as the diagonal and takes
// `+= win` after every step, so a tile's first step gives diag + win, as the
// body's first-of-tile write does.
//
// Work per step: O(S + W) to stage, mark the runs and sort, then O(S + W)
// adds per column of x — against S·W compares per column for a scan.  No
// float atomics: reruns are bit-identical.
//
// The counting sort.  Each warp ranks a contiguous share of the step's slots
// with __match_any_sync, 32 at a time in slot order, keeping one count per
// (warp, column) in shared memory.  A pass over the columns turns each
// column's counts into the offsets of the warps' shares inside its bucket and
// the column totals into bucket starts (a block-wide exclusive scan); a slot
// lands at start[col] + offset[warp][col] + rank.  Integer counts in a fixed
// order, so the permutation is the stable one on every run.  A slot whose
// column lies outside [0, W) — the padding's sentinel W — joins no bucket
// and adds nothing on the column side.
#pragma once

#include "window_kernels.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool in_window(int i, int w_pad) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(w_pad);
}

// Shared memory of one block: the (W, BT) x and result windows, then the
// staged k-step and its sort.
struct RunsSmem {
  float* xw;               // (W, BT) x window
  float* acc;              // (W, BT) result window
  int* rows;               // (S,) row_in_win of the staged slots
  int* cols;               // (S,) col_local
  float* lower;            // (S,) row side: vl·x[col] (vector x) or vl
  float* upper;            // (S,) column side: vu·x[row] (vector x) or vu
  int* rank;               // (S,) rank among the earlier slots of its
                           //      column in its warp's share
  int* perm;               // (S,) the slots, stably sorted by column
  int* start;              // (W+1,) column c's bucket: perm[start[c] ..
                           //        start[c+1])
  int* run_lo;             // (W,) row w's run: [run_lo[w], run_hi[w]),
  int* run_hi;             //      empty when both are 0
  int* warp_sum;           // (kWarps,) scan scratch
  unsigned short* count;   // (kWarps, W) per-warp column counts, then the
                           //             offsets of the warps' shares
};

__host__ __device__ inline size_t count_words(int w_pad) {
  return (static_cast<size_t>(kWarps) * w_pad + 1) / 2;
}

inline size_t runs_smem_bytes(int k_step, int w_pad, int bt) {
  return 4 * (2 * static_cast<size_t>(w_pad) * bt +
              6 * static_cast<size_t>(k_step) + 3 * w_pad + 1 + kWarps +
              count_words(w_pad));
}

__device__ __forceinline__ RunsSmem carve_runs_smem(float* base, int k_step,
                                                    int w_pad, int bt) {
  const size_t win = static_cast<size_t>(w_pad) * bt;
  RunsSmem m;
  m.xw = base;
  m.acc = base + win;
  float* p = base + 2 * win;
  m.rows = reinterpret_cast<int*>(p);
  p += k_step;
  m.cols = reinterpret_cast<int*>(p);
  p += k_step;
  m.lower = p;
  p += k_step;
  m.upper = p;
  p += k_step;
  m.rank = reinterpret_cast<int*>(p);
  p += k_step;
  m.perm = reinterpret_cast<int*>(p);
  p += k_step;
  m.start = reinterpret_cast<int*>(p);
  p += w_pad + 1;
  m.run_lo = reinterpret_cast<int*>(p);
  p += w_pad;
  m.run_hi = reinterpret_cast<int*>(p);
  p += w_pad;
  m.warp_sum = reinterpret_cast<int*>(p);
  p += kWarps;
  m.count = reinterpret_cast<unsigned short*>(p);
  return m;
}

// Sorts the staged slots [0, len) stably by column into m.perm and writes
// the bucket starts to m.start.  m.count must be zero on entry.  Every
// thread of the block calls it; it ends with a __syncthreads().
__device__ void sort_step_by_column(const RunsSmem& m, int len, int w_pad) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // each warp ranks `share` consecutive slots, 32 at a time in slot order
  const int share = (len + kWarps * 32 - 1) / (kWarps * 32) * 32;
  unsigned short* mine = m.count + warp * w_pad;
  const int lo = warp * share;
  const int hi = min(len, lo + share);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int c = i < hi ? m.cols[i] : -1;
    const bool real = in_window(c, w_pad);
    const unsigned peers = __match_any_sync(kFullMask, real ? c : -1);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (real && lane == leader) before = mine[c];
    before = __shfl_sync(kFullMask, before, leader);
    if (real) {
      m.rank[i] = before + __popc(peers & ((1u << lane) - 1u));
      if (lane == leader) {
        mine[c] = static_cast<unsigned short>(before + __popc(peers));
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // per column, in warp order: counts -> offsets of the warps' shares; the
  // column totals -> bucket starts (each thread scans a contiguous run of
  // columns, the runs joined by a warp scan and the warp totals)
  const int per = (w_pad + kThreads - 1) / kThreads;
  const int c0 = min(w_pad, tid * per);
  const int c1 = min(w_pad, c0 + per);
  int sum = 0;
  for (int c = c0; c < c1; ++c) {
    int run = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      unsigned short* at = m.count + k * w_pad + c;
      const int v = *at;
      *at = static_cast<unsigned short>(run);
      run += v;
    }
    m.start[c] = run;
    sum += run;
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) m.warp_sum[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int k = 0; k < warp; ++k) run += m.warp_sum[k];
  for (int c = c0; c < c1; ++c) {
    const int v = m.start[c];
    m.start[c] = run;
    run += v;
  }
  if (tid == kThreads - 1) m.start[w_pad] = run;   // every real slot
  __syncthreads();

  for (int i = tid; i < len; i += kThreads) {
    const int c = m.cols[i];
    if (in_window(c, w_pad)) {
      m.perm[m.start[c] + m.count[(i / share) * w_pad + c] + m.rank[i]] = i;
    }
  }
  __syncthreads();
}

// The staged rows never decrease, so each row's slots are one run: the
// slot that opens a run writes run_lo, the one that closes it run_hi.
// m.run_lo / m.run_hi must be zero on entry.
__device__ __forceinline__ void mark_row_runs(const RunsSmem& m, int len,
                                              int w_pad) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int r = m.rows[i];
    if (!in_window(r, w_pad)) continue;
    if (i == 0 || m.rows[i - 1] != r) m.run_lo[r] = i;
    if (i == len - 1 || m.rows[i + 1] != r) m.run_hi[r] = i + 1;
  }
}

// One block per (row tile, column tile); one thread per (window position,
// column) item of the result window, kThreads items at a time.  kVector: x
// is (n,) (nrhs = bt = 1) and the loading thread forms each slot's two
// products once; else they are formed per column in the sums.
template <typename V, typename I, typename Tiles, bool kVector>
__global__ void __launch_bounds__(kThreads)
onehot_runs_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, Tiles tiles, int k_step, int tm,
                   int w_pad, int n, int nrhs, int bt, int num_sym) {
  extern __shared__ float runs_smem[];
  const RunsSmem m = carve_runs_smem(runs_smem, k_step, w_pad, bt);
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * bt;            // first column of this tile
  const int cols = min(bt, nrhs - j0);       // columns in this tile
  const int tid = threadIdx.x;
  const int d0 = w_pad - tm;   // tile rows are the last TM window positions
  const int items = w_pad * cols;

  for (int q = tid; q < items; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    const long long g = window_row(b, tm, w_pad, w, n);
    const float xv =
        g >= 0 ? x[static_cast<size_t>(g) * nrhs + j0 + j] : 0.0f;
    m.xw[q] = xv;
    m.acc[q] = w >= d0 ? __fmul_rn(load_value(
                             ad, static_cast<size_t>(b) * tm + (w - d0)), xv)
                       : 0.0f;
  }

  const TileSlots ts = tiles(b);
  unsigned* count_words_smem = reinterpret_cast<unsigned*>(m.count);
  const int n_count_words = static_cast<int>(count_words(w_pad));
  for (int step0 = 0; step0 < ts.count; step0 += k_step) {
    const int len = min(k_step, ts.count - step0);
    __syncthreads();   // the x window is in; the previous step is consumed
    for (int i = tid; i < n_count_words; i += kThreads) {
      count_words_smem[i] = 0u;
    }
    for (int w = tid; w < w_pad; w += kThreads) {
      m.run_lo[w] = 0;
      m.run_hi[w] = 0;
    }
#pragma unroll 4
    for (int i = tid; i < len; i += kThreads) {
      const size_t p = ts.base + step0 + i;
      const int r = load_index(row, p);
      const int c = load_index(col, p);
      const float vl = load_value(vals_l, p);
      const float vu = num_sym ? vl : load_value(vals_u, p);
      m.rows[i] = r;
      m.cols[i] = c;
      if constexpr (kVector) {
        m.lower[i] = __fmul_rn(vl, in_window(c, w_pad) ? m.xw[c] : 0.0f);
        m.upper[i] = __fmul_rn(vu, in_window(r, w_pad) ? m.xw[r] : 0.0f);
      } else {
        m.lower[i] = vl;
        m.upper[i] = vu;
      }
    }
    __syncthreads();
    mark_row_runs(m, len, w_pad);        // read after the sort's barriers
    sort_step_by_column(m, len, w_pad);

    for (int q = tid; q < items; q += kThreads) {
      const int w = q / cols;
      const int j = q - w * cols;
      float row_sum = 0.0f;
      const int r1 = m.run_hi[w];
#pragma unroll 4
      for (int k = m.run_lo[w]; k < r1; ++k) {
        if constexpr (kVector) {
          row_sum += m.lower[k];
        } else {
          const int c = m.cols[k];
          row_sum += __fmul_rn(
              m.lower[k], in_window(c, w_pad) ? m.xw[c * cols + j] : 0.0f);
        }
      }
      float col_sum = 0.0f;
      const int k1 = m.start[w + 1];
#pragma unroll 4
      for (int k = m.start[w]; k < k1; ++k) {
        const int p = m.perm[k];
        if constexpr (kVector) {
          col_sum += m.upper[p];
        } else {
          const int r = m.rows[p];
          col_sum += __fmul_rn(
              m.upper[p], in_window(r, w_pad) ? m.xw[r * cols + j] : 0.0f);
        }
      }
      m.acc[q] += row_sum + col_sum;
    }
  }

  // each thread stores the items it accumulated
  float* dst = out + static_cast<size_t>(b) * w_pad * nrhs;
  for (int q = tid; q < items; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    dst[static_cast<size_t>(w) * nrhs + j0 + j] = m.acc[q];
  }
}

// Launches the body over NT row tiles and ceil(nrhs / bt) column tiles.
// Returns a cudaError_t: cudaErrorInvalidValue for a k-step the uint16
// counts cannot index, or whatever refuses the launch (shared memory).
template <bool kVector, typename Tiles>
int launch_onehot_runs(const void* vals_l, const void* vals_u,
                       const void* col, const void* row, const void* ad,
                       const void* x, void* out, Tiles tiles, int nt,
                       int k_step, int tm, int w_pad, int n, int nrhs, int bt,
                       int num_sym, int val_bf16, int idx_i16, void* stream) {
  if (k_step < 1 || k_step > 65535 || bt < 1 || nrhs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = runs_smem_bytes(k_step, w_pad, bt);
  const dim3 grid(nt, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e = allow_dynamic_smem(                                      \
        onehot_runs_kernel<V, I, Tiles, kVector>, smem);                     \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    onehot_runs_kernel<V, I, Tiles, kVector><<<grid, kThreads, smem, st>>>(  \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),        \
        static_cast<const I*>(col), static_cast<const I*>(row),              \
        static_cast<const V*>(ad), static_cast<const float*>(x),             \
        static_cast<float*>(out), tiles, k_step, tm, w_pad, n, nrhs, bt,     \
        num_sym);                                                            \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
