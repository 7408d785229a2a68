// K3 — one-hot block-ELL CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv.py::_kernel of the JAX package,
// which realizes gather and scatter as contractions with (S, W) one-hot
// masks of the slots' window-local column and row.  The masks are never
// materialized here: the gather side mask @ xw is xw[col] (exactly 0 for the
// column sentinel, whose one-hot row is empty), and the scatter side
// mask^T @ contrib is, for window position w, the sum over the step's slots
// of (row[s]==w)*al[s]*x[col[s]] + (col[s]==w)*au[s]*x[row[s]] taken in
// ascending s.  One thread owns one window position and scans the slots,
// which are staged through shared memory in chunks.
//
// What it keeps of the one-hot body: no atomics, a fixed order of additions
// (results are identical from run to run), O(S*W) compare work per tile, and
// the step structure — each k-step's partial window is summed on its own and
// then added to the output, the diagonal joining on the first step.
//
// Bound on this card: operations.  The scan does 2*S*W integer compares per
// tile against S slots of 8-16 bytes, so the streams are read once into
// shared memory and every thread then reads each staged slot by broadcast.
// Masks select, they do not multiply: a NaN in x reaches only the rows whose
// slots reference it, where the TPU contraction would spread it over the
// whole window.
#include "blockell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;   // slots staged per pass through shared memory

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
spmv_onehot_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, int s, int k_step, int tm,
                   int w_pad, int n, int num_sym) {
  extern __shared__ float xw[];            // (W,) x window
  __shared__ int2 rc[kChunk];              // (row, col) of the staged slots
  __shared__ float2 lu[kChunk];            // (lower, upper) values
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int w = tid; w < w_pad; w += kThreads) {
    long long g = window_row(b, tm, w_pad, w, n);
    xw[w] = g >= 0 ? x[g] : 0.0f;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * s;
  const int d0 = w_pad - tm;
  for (int w0 = 0; w0 < w_pad; w0 += kThreads) {
    const int w = w0 + tid;
    const bool active = w < w_pad;
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
            const int2 q = rc[i];
            if (q.x == w) {
              const float xg = static_cast<unsigned>(q.y) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[q.y]
                                   : 0.0f;
              win += lu[i].x * xg;
            }
            if (q.y == w) {
              const float xi = static_cast<unsigned>(q.x) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[q.x]
                                   : 0.0f;
              win += lu[i].y * xi;
            }
          }
        }
      }
      if (step0 == 0) {
        float diag = 0.0f;
        if (active && w >= d0) {
          diag = load_value(ad, static_cast<size_t>(b) * tm + (w - d0)) * xw[w];
        }
        result = diag + win;
      } else {
        result += win;
      }
    }
    if (active) out[static_cast<size_t>(b) * w_pad + w] = result;
  }
}

}  // namespace

extern "C" int blockell_spmv_onehot(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int k_step, int tm,
                                    int w_pad, int n, int num_sym,
                                    int val_bf16, int idx_i16, void* stream) {
  const size_t smem = static_cast<size_t>(w_pad) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                        \
  do {                                                                      \
    cudaError_t e = allow_dynamic_smem(spmv_onehot_kernel<V, I>, smem);     \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    spmv_onehot_kernel<V, I><<<nt, kThreads, smem, st>>>(                   \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),       \
        static_cast<const I*>(col), static_cast<const I*>(row),             \
        static_cast<const V*>(ad), static_cast<const float*>(x),            \
        static_cast<float*>(out), s, k_step, tm, w_pad, n, num_sym);        \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
