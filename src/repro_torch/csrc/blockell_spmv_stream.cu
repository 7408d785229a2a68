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
// owns a tile and loops over all of its slots (window_kernels.cuh), four
// consecutive slots per lane in one vector load of each stream.  The slots
// are row-major, so a warp's 128 slots span a few rows: each lane sums its
// slots by row, the warp sums the lanes' runs with shuffles (warp_scan.cuh),
// and a run is added into the window once, where one shared atomicAdd per
// slot serialized up to 32 lanes on one word.  The column half keeps one
// atomicAdd per slot, each lane taking its four slots in a swizzled order so
// that a long row's consecutive columns land in 32 different banks.  The
// order of additions inside a window varies from run to run (exact on
// dyadic data, rounding-level otherwise).
//
// The column sentinel (col == W) is clamped for the gather and skipped for
// the scatter (an unguarded acc[W] would be out of bounds).  The row side of
// a padded slot still adds 0*x to the tile's last row, as in the TPU body:
// the padding trails the tile, so that is one add per warp of padding.
// S must be a multiple of 128 and the slot streams 16-byte aligned; the
// wrapper checks both.
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
