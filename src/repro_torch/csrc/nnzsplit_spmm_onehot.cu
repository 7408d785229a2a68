// K12 — one-hot nnz-split CSRC SpMM partials (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel_mm of the JAX
// package: K11 (nnzsplit_spmv_onehot.cu) for X of shape (n, B), the one-hot
// (S, r_pad) matrix contracted with the (S, B) products.
//
// One block owns one (chunk, column tile) pair.  The staged products are
// (512, BT) and the partial (r_pad, BT) lives in shared memory, both inside
// a 64 KB budget that sets BT; thread q owns output (r, j) = (q / BT,
// q % BT) and adds, in slot order, the staged products of row r in column
// j.  A fixed order of additions, no atomics, bit-identical reruns; masks
// select, they do not multiply.
//
// Bound on this card: operations — S * r_pad * B compares per chunk.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmm_onehot(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int nrhs, int bt, int val_bf16,
                                    int idx_i16, void* stream) {
  return launch_chunk_onehot(vals, lrow, src, x, out, num_chunks, s, r_pad, n,
                             nrhs, bt, val_bf16, idx_i16, stream);
}
