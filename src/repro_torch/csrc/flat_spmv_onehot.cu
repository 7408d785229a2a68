// K7 — one-hot flat-grid CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel of the JAX
// package, which realizes gather and scatter of each k-step as contractions
// with (S, W) one-hot masks, the step's row tile read from `tile_of_step`,
// the window initialized with the diagonal plus the step's partial on the
// tile's first step (`first_of_tile`) and `out += win` on later steps.
//
// One block owns one row tile and walks the tile's steps
// [step_start[b], step_start[b+1]) in order, with the body of
// window_runs.cuh.  Per step the loading thread of each slot forms its two
// products (vl·x[col], vu·x[row]) once; window row w sums the run of slots
// whose row is w (the step's rows never decrease, so the slots that open
// and close a run mark its bounds) and column w the bucket of slots whose
// column is w (a stable counting sort of the step by column in shared
// memory), each in slot order, and the window takes their sum — the TPU
// body's two contractions, added.  No float atomics: reruns are
// bit-identical.  A match selects x, it does not multiply a mask (a NaN in
// x reaches only the rows that reference it).
//
// Before: one thread per window position scanned every slot of every step
// (a scan body since removed), S·W compares per step — 5.1e10 at the
// skewed main shape, 30.05 ms, operations at 75x its bytes bound.
//
// Bound on this card: neither bytes nor operations but a block's latency
// through each step — the global loads of the staging, the barriers of the
// sort, and the longest run (a wide-band row of some 512 slots, summed in
// order by one thread) — hidden only by the other blocks on the SM (4 per
// SM: 62 registers a thread, ~48 KB of shared memory at W = 640).
#include "window_runs.cuh"

extern "C" int flat_spmv_onehot(const void* vals_l, const void* vals_u,
                                const void* col, const void* row,
                                const void* ad, const void* step_start,
                                const void* x, void* out, int nt, int step,
                                int tm, int w_pad, int n, int num_sym,
                                int val_bf16, int idx_i16, void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_onehot_runs<true>(vals_l, vals_u, col, row, ad, x, out,
                                  tiles, nt, step, tm, w_pad, n, 1, 1,
                                  num_sym, val_bf16, idx_i16, stream);
}
