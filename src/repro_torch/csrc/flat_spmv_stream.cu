// K5 — streaming flat-grid CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel_stream of the JAX
// package.  That body runs a 1-D grid over per-tile-exact k-steps: each step
// reads its row tile from `tile_of_step`, gathers x[ja] and x[i] from the
// tile's x window, forms al*x[ja] -> row and au*x[i] -> column, segment-sums
// both into the W-wide window, and on the tile's first step (`first_of_tile`)
// initializes the window with the diagonal; later steps add to it.
//
// Here one block owns one row tile and loops over the tile's steps
// [step_start[b], step_start[b+1]), which the wrapper derives once from
// `tile_of_step` / `first_of_tile` and validates (a tile's steps are
// contiguous, every tile has at least one).  Inside a tile the body is K1's
// (window_kernels.cuh): x window and accumulator in shared memory, one
// coalesced read of every stream, shared-memory atomicAdd for the scatter,
// the column sentinel clamped for the gather and skipped for the scatter, x
// bounds-checked instead of padded, the diagonal added after the atomics.
// The order of additions inside a window varies from run to run (exact on
// dyadic data, rounding-level otherwise).
//
// Bound on this card: bytes.  Per slot it reads 8-16 bytes and does four
// flops.  What holds it back on skewed matrices: the slots of one row are
// neighbours in the stream, so on a row of a wide band all 32 lanes of a
// warp add into one shared word and the row-side atomics serialize; and the
// tiles of the wide band carry many steps each while the rest carry one, so
// the heavy blocks finish last.  A warp-segmented row sum and splitting heavy
// tiles across blocks are the known cures, left to a later change.
#include "window_kernels.cuh"

extern "C" int flat_spmv_stream(const void* vals_l, const void* vals_u,
                                const void* col, const void* row,
                                const void* ad, const void* step_start,
                                const void* x, void* out, int nt, int step,
                                int tm, int w_pad, int n, int num_sym,
                                int val_bf16, int idx_i16, void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_spmv_stream(vals_l, vals_u, col, row, ad, x, out, tiles, nt,
                            tm, w_pad, n, num_sym, val_bf16, idx_i16, stream);
}
