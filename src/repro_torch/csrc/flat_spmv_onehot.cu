// K7 — one-hot flat-grid CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel of the JAX
// package, which realizes gather and scatter of each k-step as contractions
// with (S, W) one-hot masks, the step's row tile read from `tile_of_step`,
// the window initialized with the diagonal plus the step's partial on the
// tile's first step (`first_of_tile`) and `out += win` on later steps.
//
// One block owns one row tile and walks the tile's steps
// [step_start[b], step_start[b+1]) in order.  Inside a tile the body is
// K3's (window_kernels.cuh): the masks are never built; one thread owns one
// window position and scans each step's slots in ascending order, adding
// (row==w)*al*x[col] + (col==w)*au*x[row]; each step's partial is summed on
// its own, the diagonal joins on the first step, then `result += win` step
// after step — the TPU body's order, with no atomics, so reruns are
// bit-identical.  Masks select, they do not multiply (a NaN in x reaches
// only the rows that reference it).
//
// Bound on this card: operations — 2*S*W compares per step against S slots
// of 8-16 bytes.  The slots are staged through shared memory in chunks and
// read by broadcast.  On a skewed matrix the tiles of the wide band carry
// many steps each, so their blocks dominate the run.
#include "window_kernels.cuh"

extern "C" int flat_spmv_onehot(const void* vals_l, const void* vals_u,
                                const void* col, const void* row,
                                const void* ad, const void* step_start,
                                const void* x, void* out, int nt, int step,
                                int tm, int w_pad, int n, int num_sym,
                                int val_bf16, int idx_i16, void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_spmv_onehot(vals_l, vals_u, col, row, ad, x, out, tiles, nt,
                            step, tm, w_pad, n, num_sym, val_bf16, idx_i16,
                            stream);
}
