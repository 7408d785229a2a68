// K10 — streaming nnz-split CSRC SpMM partials (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel_mm_stream of
// the JAX package: K9 (nnzsplit_spmv_stream.cu) for X of shape (n, B) — per
// entry the row X[src, :] times the value, segment-summed by lrow into a
// (r_pad, B) partial; (C, r_pad, B) out.
//
// One block owns one (chunk, column tile) pair: the B axis is cut into
// column tiles of BT columns so that the (r_pad, BT) accumulator stays under
// a 64 KB shared-memory budget (grid.y).  A thread loads an entry's value,
// lrow and src once and walks the tile's columns; the warp's run structure
// (which lanes share a row) is computed once per step and reused for every
// column, so each column costs five shuffles and one atomic per run.
//
// Bound on this card: bytes.  The streams amortize over the B columns, but
// each entry reads a 4·B-byte row of X: at B = 11 and n = 2,097,152, X is
// 92 MB, larger than L2, so the gather goes to device memory.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmm_stream(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int nrhs, int bt, int val_bf16,
                                    int idx_i16, void* stream) {
  return launch_chunk_stream(vals, lrow, src, x, out, num_chunks, s, r_pad, n,
                             nrhs, bt, val_bf16, idx_i16, stream);
}
