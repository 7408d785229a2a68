// K6 — streaming flat-grid CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel_mm_stream of the
// JAX package: K5 (flat_spmv_stream.cu) for X of shape (n, B) — per slot a
// row gather of the (W, B) x window, al*x[ja,:] -> row and au*x[i,:] ->
// column, summed into the tile's (W, B) window over the tile's k-steps, the
// diagonal joining once; (NT, W, B) out.
//
// One block owns one (row tile, column tile) pair and loops over the tile's
// steps [step_start[b], step_start[b+1]).  Inside a tile the body is K2's
// (window_kernels.cuh): the (W, BT) x window and accumulator in shared
// memory, the B axis cut into column tiles of BT columns under a 64 KB
// budget (grid.y), (slot, column) work items with the column fastest, so a
// warp reads neighbouring shared words and one slot's indices by broadcast;
// shared-memory atomicAdd for the scatter (order varies from run to run,
// exact on dyadic data); sentinels and x bounds as in K5.
//
// Bound on this card: bytes — the value and index streams amortize over the
// B columns.  With B columns a warp's 32 lanes cover 32/B slots, so the
// row-side atomics of a wide-band row collide on B distinct words instead of
// one: less serialized than K5, but the heavy tiles remain a tail.
#include "window_kernels.cuh"

extern "C" int flat_spmm_stream(const void* vals_l, const void* vals_u,
                                const void* col, const void* row,
                                const void* ad, const void* step_start,
                                const void* x, void* out, int nt, int step,
                                int tm, int w_pad, int n, int nrhs, int bt,
                                int num_sym, int val_bf16, int idx_i16,
                                void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_spmm_stream(vals_l, vals_u, col, row, ad, x, out, tiles, nt,
                            tm, w_pad, n, nrhs, bt, num_sym, val_bf16,
                            idx_i16, stream);
}
