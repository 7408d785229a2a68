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
#include "window_kernels.cuh"

extern "C" int blockell_spmv_onehot(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int k_step, int tm,
                                    int w_pad, int n, int num_sym,
                                    int val_bf16, int idx_i16, void* stream) {
  return launch_spmv_onehot(vals_l, vals_u, col, row, ad, x, out,
                            RectTiles{s}, nt, k_step, tm, w_pad, n, num_sym,
                            val_bf16, idx_i16, stream);
}
