// K2 — streaming block-ELL CSRC SpMM windows (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmm.py::_kernel_stream of the JAX
// package: K1 (blockell_spmv_stream.cu) for X of shape (n, B) — per slot a
// row gather of the (W, B) x window, al*x[ja,:] -> row and au*x[i,:] ->
// column, summed into the (W, B) window, plus the diagonal; (NT, W, B) out.
//
// Bound on this card: bytes.  The value and index streams amortize over the
// B columns, so x and the windows dominate as B grows; both stay in shared
// memory while a tile is processed.  (W, B) float32 twice passes a block's
// shared memory already at W=4096, B=8, so the B axis is cut into column
// tiles of BT columns (grid.y) sized to a 64 KB budget; a tile's slots are
// re-read once per column tile.  The body (window_kernels.cuh) is K1's with
// a loop over the tile's columns: a lane reads four consecutive slots once
// per pass, the warp's runs of equal rows are found once per pass, and per
// column the row half is summed per lane and across the warp before one
// shared add per run piece, the column half one shared add per slot in a
// swizzled slot order (32 banks on a long row at the windows' odd row
// stride).  Rows never decrease inside a tile (blockell.check_slot_order)
// and the streams are 16-byte aligned (_build.check_lane_loads).  The
// order of additions varies from run to run (exact on dyadic data).
//
// Sentinel handling as in K1: column sentinel clamped for the gather and
// skipped for the scatter; the row side of a padded slot adds 0*x.
#include "window_kernels.cuh"

extern "C" int blockell_spmm_stream(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int tm, int w_pad, int n,
                                    int nrhs, int bt, int num_sym,
                                    int val_bf16, int idx_i16, void* stream) {
  return launch_spmm_stream(vals_l, vals_u, col, row, ad, x, out,
                            RectTiles{s}, nt, tm, w_pad, n, nrhs, bt, num_sym,
                            val_bf16, idx_i16, stream);
}
