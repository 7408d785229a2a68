// K2 — streaming block-ELL CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmm.py::_kernel_stream of the JAX
// package: K1 (blockell_spmv_stream.cu) for X of shape (n, B) — per slot a
// row gather of the (W, B) x window, al*x[ja,:] -> row and au*x[i,:] ->
// column, summed into the (W, B) window, plus the diagonal; (NT, W, B) out.
//
// Bound on this card: bytes.  The value and index streams amortize over the
// B columns, so x and the windows dominate as B grows; both stay in shared
// memory while a tile is processed.  (W, B) float32 twice passes a block's
// shared memory already at W=4096, B=8, so the B axis is cut into column
// tiles of BT columns (grid.y) sized to a 64 KB budget, which keeps several
// blocks resident per SM; a tile's slots are re-read once per column tile.
// Work items are (slot, column) pairs with the column fastest, so a warp
// reads neighbouring shared-memory words and one slot's indices by
// broadcast.  The scatter is a shared-memory atomicAdd: the order of
// additions varies from run to run (exact on dyadic data).
//
// Sentinel handling as in K1: column sentinel clamped for the gather and
// skipped for the scatter; the row side of a padded slot adds 0*x.
#include "blockell_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
spmm_stream_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, int s, int tm, int w_pad, int n,
                   int nrhs, int bt, int num_sym) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * bt;           // first column of this tile
  const int cols = min(bt, nrhs - j0);      // columns in this tile
  const int tid = threadIdx.x;
  float* xw = smem;                          // (W, cols) x window
  float* acc = smem + static_cast<size_t>(w_pad) * bt;   // (W, cols)

  const int items_w = w_pad * cols;
  for (int q = tid; q < items_w; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    long long g = window_row(b, tm, w_pad, w, n);
    xw[q] = g >= 0 ? x[static_cast<size_t>(g) * nrhs + j0 + j] : 0.0f;
    acc[q] = 0.0f;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * s;
  const long long items_s = static_cast<long long>(s) * cols;
  for (long long q = tid; q < items_s; q += kThreads) {
    const int p = static_cast<int>(q / cols);
    const int j = static_cast<int>(q - static_cast<long long>(p) * cols);
    const int c = load_index(col, base + p);
    const int r = load_index(row, base + p);
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(w_pad)) continue;
    const float vl = load_value(vals_l, base + p);
    const int cg = min(max(c, 0), w_pad - 1);
    atomicAdd(&acc[r * cols + j], vl * xw[cg * cols + j]);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(w_pad)) {
      const float vu = num_sym ? vl : load_value(vals_u, base + p);
      atomicAdd(&acc[c * cols + j], vu * xw[r * cols + j]);
    }
  }
  __syncthreads();

  const int d0 = w_pad - tm;
  const int items_d = tm * cols;
  for (int q = tid; q < items_d; q += kThreads) {
    const int t = q / cols;
    const int j = q - t * cols;
    const int at = (d0 + t) * cols + j;
    acc[at] += load_value(ad, static_cast<size_t>(b) * tm + t) * xw[at];
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(b) * w_pad * nrhs;
  for (int q = tid; q < items_w; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    dst[static_cast<size_t>(w) * nrhs + j0 + j] = acc[q];
  }
}

}  // namespace

extern "C" int blockell_spmm_stream(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int tm, int w_pad, int n,
                                    int nrhs, int bt, int num_sym,
                                    int val_bf16, int idx_i16, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w_pad) * bt * sizeof(float);
  const dim3 grid(nt, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                        \
  do {                                                                      \
    cudaError_t e = allow_dynamic_smem(spmm_stream_kernel<V, I>, smem);     \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    spmm_stream_kernel<V, I><<<grid, kThreads, smem, st>>>(                 \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),       \
        static_cast<const I*>(col), static_cast<const I*>(row),             \
        static_cast<const V*>(ad), static_cast<const float*>(x),            \
        static_cast<float*>(out), s, tm, w_pad, n, nrhs, bt, num_sym);      \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
