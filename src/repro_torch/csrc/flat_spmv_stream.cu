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
// coalesced read of every stream (four consecutive slots per lane, 128 per
// warp, in vector loads), the row half summed per run of equal rows by each
// lane and then across the warp (warp_scan.cuh; a step's rows never
// decrease and a warp never crosses a step) and added once per run, the
// column half one shared-memory atomicAdd per slot in a swizzled slot order
// (a wide row's consecutive columns in 32 banks), the column sentinel
// clamped for the gather and skipped for the scatter, x bounds-checked
// instead of padded, the diagonal added after the atomics.  The order of
// additions inside a window varies from run to run (exact on dyadic data,
// rounding-level otherwise).
//
// Bound on this card: bytes.  Per slot it reads 8-16 bytes and does four
// flops.  On skewed matrices the slots of a wide-band row are neighbours in
// the stream: with one add per slot all 32 lanes of a warp serialized on
// one shared word; with the run sums a warp adds about once per row.  The
// tiles of the wide band carry many steps each while the rest carry one.
// They are the first blocks launched and fit the card at once (about 7.5
// per SM against 8 resident), so they run side by side, not as a tail
// after the light ones: one block per tile stays (measured: PERF.md).
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
