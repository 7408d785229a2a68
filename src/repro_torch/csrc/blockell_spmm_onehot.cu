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
#include "window_kernels.cuh"

extern "C" int blockell_spmm_onehot(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int k_step, int tm,
                                    int w_pad, int n, int nrhs, int bt,
                                    int num_sym, int val_bf16, int idx_i16,
                                    void* stream) {
  return launch_spmm_onehot(vals_l, vals_u, col, row, ad, x, out,
                            RectTiles{s}, nt, k_step, tm, w_pad, n, nrhs, bt,
                            num_sym, val_bf16, idx_i16, stream);
}
