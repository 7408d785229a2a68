// K4 — one-hot block-ELL CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmm.py::_kernel of the JAX package:
// the one-hot form of K3 (blockell_spmv_onehot.cu) with genuine
// (S, W) @ (W, B) gathers and (W, S) @ (S, B) scatters per k-step, the
// diagonal joining on the first step, `out += win` on later steps.
//
// One block owns one (row tile, column tile) pair (RectTiles) and walks the
// tile's steps in order with the body of window_runs.cuh: per step the
// slots are staged, the row runs of the real slots marked and the column
// buckets formed by a stable counting sort — once, for all the tile's
// columns; then each (window position, column) item sums its run and its
// bucket in slot order, forming each product per column, and the window
// takes their sum.  The (W, BT) x and result windows sit in shared memory
// under a 64 KB budget (grid.y over column tiles of column_tile(W, B, 2)).
// No float atomics, a fixed order of additions, bit-identical reruns; at
// B = 1 the result equals K3's bit for bit.
//
// Before: one thread per (position, column) scanned every slot of every
// step, S·W·B compares per step — 46.65 ms at the main path's shape (W 256,
// B 11), bound by those compares, not by bytes.
//
// Bound on this card: a block's latency through each step — the staging
// loads, the sort's barriers, and the longest run, summed in order by one
// thread per column with a dependent x load per slot.  Shared memory (the
// two windows and the staged step) is 54.3 KB at W = 256, B = 11: about 4
// blocks per SM.  The work per step is O((S + W)·B) adds plus the sort.
#include "window_runs.cuh"

extern "C" int blockell_spmm_onehot(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int k_step, int tm,
                                    int w_pad, int n, int nrhs, int bt,
                                    int num_sym, int val_bf16, int idx_i16,
                                    void* stream) {
  return launch_onehot_runs<false>(vals_l, vals_u, col, row, ad, x, out,
                                   RectTiles{s}, nt, k_step, tm, w_pad, n,
                                   nrhs, bt, num_sym, val_bf16, idx_i16,
                                   stream);
}
