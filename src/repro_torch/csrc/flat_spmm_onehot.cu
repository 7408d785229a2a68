// K8 — one-hot flat-grid CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel_mm of the JAX
// package: the one-hot form of K7 (flat_spmv_onehot.cu) with genuine
// (S, W) @ (W, B) gathers and (W, S) @ (S, B) scatters per k-step, the
// diagonal joining on the tile's first step, `out += win` on later steps.
//
// One block owns one (row tile, column tile) pair and walks the tile's steps
// [step_start[b], step_start[b+1]) in order.  Inside a tile the body is K4's
// (window_kernels.cuh): one thread per (window position, column) scanning
// each step's slots in ascending order, the (W, BT) x window in shared
// memory under a 64 KB budget (grid.y over column tiles), no atomics, a fixed
// order of additions, bit-identical reruns.
//
// Bound on this card: operations — 2*S*W*B compares per step.  The faster
// form is the (W, S) @ (S, B) contraction on tensor cores, left to a later
// change; on a skewed matrix the many-step tiles of the wide band dominate.
#include "window_kernels.cuh"

extern "C" int flat_spmm_onehot(const void* vals_l, const void* vals_u,
                                const void* col, const void* row,
                                const void* ad, const void* step_start,
                                const void* x, void* out, int nt, int step,
                                int tm, int w_pad, int n, int nrhs, int bt,
                                int num_sym, int val_bf16, int idx_i16,
                                void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_spmm_onehot(vals_l, vals_u, col, row, ad, x, out, tiles, nt,
                            step, tm, w_pad, n, nrhs, bt, num_sym, val_bf16,
                            idx_i16, stream);
}
