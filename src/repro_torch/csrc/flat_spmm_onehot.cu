// K8 — one-hot flat-grid CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel_mm of the JAX
// package: the one-hot form of K7 (flat_spmv_onehot.cu) with genuine
// (S, W) @ (W, B) gathers and (W, S) @ (S, B) scatters per k-step, the
// diagonal joining on the tile's first step, `out += win` on later steps.
//
// One block owns one (row tile, column tile) pair and walks the tile's steps
// [step_start[b], step_start[b+1]) in order, with the body of
// window_runs.cuh: per step the slots are staged, the row runs marked and
// the column buckets formed by a stable counting sort — once, for all the
// tile's columns; then each (window position, column) item sums its run and
// its bucket in slot order, forming each product per column, and the window
// takes their sum.  The (W, BT) x and result windows sit in shared memory
// under a 64 KB budget (grid.y over column tiles).  No float atomics, a
// fixed order of additions, bit-identical reruns; at B = 1 the result
// equals K7's bit for bit.
//
// Before: one thread per (position, column) scanned every slot of every
// step (K4's body, still in window_kernels.cuh), S·W·B compares per step,
// 515x its bytes bound at the skewed main shape.
//
// Bound on this card: a block's latency through each step, chiefly the
// longest run, summed in order by one thread per column with a dependent x
// load per slot; 2 blocks per SM (shared memory: the two windows and the
// staged step, ~99 KB at W = 640, B = 11).  The work per step is
// O((S + W)·B) adds plus the sort.
#include "window_runs.cuh"

extern "C" int flat_spmm_onehot(const void* vals_l, const void* vals_u,
                                const void* col, const void* row,
                                const void* ad, const void* step_start,
                                const void* x, void* out, int nt, int step,
                                int tm, int w_pad, int n, int nrhs, int bt,
                                int num_sym, int val_bf16, int idx_i16,
                                void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_onehot_runs<false>(vals_l, vals_u, col, row, ad, x, out,
                                   tiles, nt, step, tm, w_pad, n, nrhs, bt,
                                   num_sym, val_bf16, idx_i16, stream);
}
