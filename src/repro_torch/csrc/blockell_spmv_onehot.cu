// K3 — one-hot block-ELL CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv.py::_kernel of the JAX package,
// which realizes gather and scatter of each k-step as contractions with
// (S, W) one-hot masks of the slots' window-local column and row,
// win = oh_rows^T·(vl·x[col]) + oh_cols^T·(vu·x[row]), the window
// initialized with the diagonal plus the first step's partial and
// `out += win` on later steps.
//
// One block owns one row tile (RectTiles: S slots, S/k_step steps) and walks
// its steps in order with the body of window_runs.cuh.  Per step the loading
// thread of each slot forms its two products (vl·x[col], vu·x[row]) once;
// window row w sums the run of real slots whose row is w (the tile's rows
// never decrease and its padding trails, so the real slots that open and
// close a run mark its bounds, and padding joins no run) and column w the
// bucket of slots whose column is w (a stable counting sort of the step by
// column in shared memory), each in slot order, and the window takes their
// sum — the TPU body's two contractions, added.  No float atomics: reruns
// are bit-identical.  A match selects x, it does not multiply a mask (a NaN
// in x reaches only the rows that reference it).
//
// Before: one thread per window position scanned every slot of every step,
// S·W = 524,288 compares per step at the main path's shape (NT 16,384,
// S 2,048, W 256, k-step 1,024) — 5.627 ms per launch, bound by those
// compares, not by bytes.
//
// Bound on this card: neither bytes nor operations but a block's latency
// through each step — the global loads of the staging, the barriers of the
// sort, and the longest run (a band row of some 24 real slots, summed in
// order by one thread; the padding no longer lengthens the last row's) —
// hidden by the other blocks on the SM (shared memory 33.8 KB at W = 256,
// k-step 1,024: about 4 blocks of 256 threads per SM).  Two steps per tile
// at the main shape, so the per-step latency is paid twice per window.
#include "window_runs.cuh"

extern "C" int blockell_spmv_onehot(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int k_step, int tm,
                                    int w_pad, int n, int num_sym,
                                    int val_bf16, int idx_i16, void* stream) {
  return launch_onehot_runs<true>(vals_l, vals_u, col, row, ad, x, out,
                                  RectTiles{s}, nt, k_step, tm, w_pad, n, 1,
                                  1, num_sym, val_bf16, idx_i16, stream);
}
