// K6 — streaming flat-grid CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_flat.py::_kernel_mm_stream of the
// JAX package: K5 (flat_spmv_stream.cu) for X of shape (n, B) — per slot a
// row gather of the (W, B) x window, al*x[ja,:] -> row and au*x[i,:] ->
// column, summed into the tile's (W, B) window over the tile's k-steps, the
// diagonal joining once; (NT, W, B) out.
//
// One block owns one (row tile, column tile) pair and loops over the tile's
// steps [step_start[b], step_start[b+1]).  The body is K2's
// (window_kernels.cuh), which is K5's with a loop over the columns: the
// (W, BT) x window and accumulator in shared memory at an odd row stride,
// the B axis cut into column tiles of BT columns under a 64 KB budget
// (grid.y); four consecutive slots per lane read once per pass in vector
// loads, the warp's runs of equal rows found once per pass; per column the
// row half summed per lane and across the warp and added once per run
// piece, the column half one shared add per slot in K5's swizzled order.
// Needs K5's row order and lane loads (blockell.check_slot_order where the
// pack is built, loaded or converted; _build.check_lane_loads in the
// wrapper).  The order of additions varies from run to run (exact on dyadic
// data).
//
// Bound on this card: bytes — the slot streams amortize over the B
// columns.  On skewed matrices the wide band's tiles carry up to 64 steps
// each and take most of the time (measured: PERF.md).
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
