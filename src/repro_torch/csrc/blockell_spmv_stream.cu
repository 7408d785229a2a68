// K1 — streaming block-ELL CSRC SpMV windows.
//
// Replaces the TPU body kernels/csrc_spmv.py::_kernel_stream of the JAX
// package: per row tile, gather x[ja] and x[i] from the tile's x window,
// form al*x[ja] -> row and au*x[i] -> column (au = al when the matrix is
// numerically symmetric, and then vals_u is never read), sum both into the
// W-wide window, add the diagonal, write the (NT, W) windows.
//
// Bound on this card: bytes.  Per slot the kernel must read 8-16 bytes and
// does four flops, far below the card's flop-per-byte balance.  The design
// therefore reads every stream exactly once, coalesced, and keeps the x
// window and the accumulator in shared memory (2*W*4 bytes, at most 32 KB):
// the gather and the scatter-add never touch device memory.  The TPU grid
// revisited one output block across its k-steps in order; here one block
// owns a tile and loops over all of its slots, and the scatter is a
// shared-memory atomicAdd, so the order of additions inside a window varies
// from run to run (exact on dyadic data, rounding-level otherwise).
//
// The column sentinel (col == W) is clamped for the gather and skipped for
// the scatter (an unguarded acc[W] would be out of bounds).  The row side of
// a padded slot still adds 0*x to the tile's last row, as in the TPU body.
#include "window_kernels.cuh"

extern "C" int blockell_spmv_stream(const void* vals_l, const void* vals_u,
                                    const void* col, const void* row,
                                    const void* ad, const void* x, void* out,
                                    int nt, int s, int tm, int w_pad, int n,
                                    int num_sym, int val_bf16, int idx_i16,
                                    void* stream) {
  return launch_spmv_stream(vals_l, vals_u, col, row, ad, x, out,
                            RectTiles{s}, nt, tm, w_pad, n, num_sym, val_bf16,
                            idx_i16, stream);
}
