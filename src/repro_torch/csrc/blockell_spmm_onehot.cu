// K4 — one-hot block-ELL CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmm.py::_kernel of the JAX package:
// the one-hot form of K3 (blockell_spmv_onehot.cu) with genuine
// (S, W) @ (W, B) gathers and (W, S) @ (S, B) scatters.  As in K3 the masks
// are never built: one thread owns one (window position, column) pair and
// scans the step's slots in ascending order, adding al[s]*x[col[s], j] where
// row[s] matches and au[s]*x[row[s], j] where col[s] matches.  No atomics, a
// fixed order of additions, results identical from run to run, and the step
// structure of the TPU body (each k-step's partial summed on its own, the
// diagonal joining on the first step).
//
// Bound on this card: operations — 2*S*W*B integer compares per tile.  The
// (W, BT) x window sits in shared memory, BT columns per block (grid.y)
// under a 64 KB budget; the slots are staged through shared memory in chunks
// and read by broadcast.  A tensor-core contraction is the faster form of
// this body and is left to a later change.  Masks select, they do not
// multiply: a NaN in x reaches only the rows whose slots reference it.
#include "blockell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;   // slots staged per pass through shared memory

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
spmm_onehot_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, int s, int k_step, int tm,
                   int w_pad, int n, int nrhs, int bt, int num_sym) {
  extern __shared__ float xw[];            // (W, cols) x window
  __shared__ int2 rc[kChunk];              // (row, col) of the staged slots
  __shared__ float2 lu[kChunk];            // (lower, upper) values
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * bt;
  const int cols = min(bt, nrhs - j0);
  const int tid = threadIdx.x;

  const int items = w_pad * cols;
  for (int q = tid; q < items; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    long long g = window_row(b, tm, w_pad, w, n);
    xw[q] = g >= 0 ? x[static_cast<size_t>(g) * nrhs + j0 + j] : 0.0f;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * s;
  const int d0 = w_pad - tm;
  for (int q0 = 0; q0 < items; q0 += kThreads) {
    const int q = q0 + tid;
    const bool active = q < items;
    const int w = active ? q / cols : -1;
    const int j = active ? q - w * cols : 0;
    float result = 0.0f;
    for (int step0 = 0; step0 < s; step0 += k_step) {
      const int step1 = min(step0 + k_step, s);
      float win = 0.0f;
      for (int c0 = step0; c0 < step1; c0 += kChunk) {
        const int len = min(kChunk, step1 - c0);
        __syncthreads();   // the previous chunk has been consumed
        for (int i = tid; i < len; i += kThreads) {
          const size_t p = base + c0 + i;
          const float vl = load_value(vals_l, p);
          rc[i] = make_int2(load_index(row, p), load_index(col, p));
          lu[i] = make_float2(vl, num_sym ? vl : load_value(vals_u, p));
        }
        __syncthreads();
        if (active) {
          for (int i = 0; i < len; ++i) {
            const int2 m = rc[i];
            if (m.x == w) {
              const float xg = static_cast<unsigned>(m.y) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[m.y * cols + j]
                                   : 0.0f;
              win += lu[i].x * xg;
            }
            if (m.y == w) {
              const float xi = static_cast<unsigned>(m.x) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[m.x * cols + j]
                                   : 0.0f;
              win += lu[i].y * xi;
            }
          }
        }
      }
      if (step0 == 0) {
        float diag = 0.0f;
        if (active && w >= d0) {
          diag = load_value(ad, static_cast<size_t>(b) * tm + (w - d0)) * xw[q];
        }
        result = diag + win;
      } else {
        result += win;
      }
    }
    if (active) {
      out[(static_cast<size_t>(b) * w_pad + w) * nrhs + j0 + j] = result;
    }
  }
}

}  // namespace

extern "C" int blockell_spmm_onehot(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int k_step, int tm,
                                    int w_pad, int n, int nrhs, int bt,
                                    int num_sym, int val_bf16, int idx_i16,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(w_pad) * bt * sizeof(float);
  const dim3 grid(nt, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                        \
  do {                                                                      \
    cudaError_t e = allow_dynamic_smem(spmm_onehot_kernel<V, I>, smem);     \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    spmm_onehot_kernel<V, I><<<grid, kThreads, smem, st>>>(                 \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),       \
        static_cast<const I*>(col), static_cast<const I*>(row),             \
        static_cast<const V*>(ad), static_cast<const float*>(x),            \
        static_cast<float*>(out), s, k_step, tm, w_pad, n, nrhs, bt,        \
        num_sym);                                                           \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
