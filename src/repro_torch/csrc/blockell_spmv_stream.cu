// K1 — streaming block-ELL CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv.py::_kernel_stream of the JAX
// package: per row tile, gather x[ja] and x[i] from the tile's x window,
// form al*x[ja] -> row and au*x[i] -> column (au = al when the matrix is
// numerically symmetric, and then vals_u is never read), sum both into the
// W-wide window, add the diagonal, write the (NT, W) windows.
//
// Bound on this card: bytes.  Per slot the kernel must read 8-16 bytes and
// does four flops, far below the card's flop-per-byte balance.  The design
// therefore reads every stream exactly once, coalesced, and keeps the x
// window and the accumulator in shared memory (2*W*4 bytes, at most 32 KB):
// the gather and the scatter-add never touch device memory.  The TPU grid
// revisited one output block across its k-steps in order; here one block
// owns a tile and loops over all of its slots, and the scatter is a
// shared-memory atomicAdd, so the order of additions inside a window varies
// from run to run (exact on dyadic data, rounding-level otherwise).
//
// The column sentinel (col == W) is clamped for the gather and skipped for
// the scatter (an unguarded acc[W] would be out of bounds).  The row side of
// a padded slot still adds 0*x to the tile's last row, as in the TPU body.
#include "blockell_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
spmv_stream_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, int s, int tm, int w_pad, int n,
                   int num_sym) {
  extern __shared__ float smem[];
  float* xw = smem;            // (W,) x window
  float* acc = smem + w_pad;   // (W,) output window
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int w = tid; w < w_pad; w += kThreads) {
    long long g = window_row(b, tm, w_pad, w, n);
    xw[w] = g >= 0 ? x[g] : 0.0f;
    acc[w] = 0.0f;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * s;
  for (int p = tid; p < s; p += kThreads) {
    const int c = load_index(col, base + p);
    const int r = load_index(row, base + p);
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(w_pad)) continue;
    const float vl = load_value(vals_l, base + p);
    const int cg = min(max(c, 0), w_pad - 1);
    atomicAdd(&acc[r], vl * xw[cg]);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(w_pad)) {
      const float vu = num_sym ? vl : load_value(vals_u, base + p);
      atomicAdd(&acc[c], vu * xw[r]);
    }
  }
  __syncthreads();

  const int d0 = w_pad - tm;   // tile rows are the last TM window positions
  for (int t = tid; t < tm; t += kThreads) {
    acc[d0 + t] += load_value(ad, static_cast<size_t>(b) * tm + t) * xw[d0 + t];
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(b) * w_pad;
  for (int w = tid; w < w_pad; w += kThreads) dst[w] = acc[w];
}

}  // namespace

extern "C" int blockell_spmv_stream(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int tm, int w_pad, int n,
                                    int num_sym, int val_bf16, int idx_i16,
                                    void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w_pad) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                        \
  do {                                                                      \
    cudaError_t e = allow_dynamic_smem(spmv_stream_kernel<V, I>, smem);     \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    spmv_stream_kernel<V, I><<<nt, kThreads, smem, st>>>(                   \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),       \
        static_cast<const I*>(col), static_cast<const I*>(row),             \
        static_cast<const V*>(ad), static_cast<const float*>(x),            \
        static_cast<float*>(out), s, tm, w_pad, n, num_sym);                \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
