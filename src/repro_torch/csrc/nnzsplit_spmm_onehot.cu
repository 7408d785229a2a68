// K12 — one-hot nnz-split CSRC SpMM partials (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel_mm of the JAX
// package: K11 (nnzsplit_spmv_onehot.cu) for X of shape (n, B), the one-hot
// (S, r_pad) matrix of lrow contracted with the (S, B) products vals·X[src].
//
// Ported from the math, not the mask (chunk_kernels.cuh, chunk_runs_kernel):
// lrow never decreases inside a chunk, so each row's entries are one run.
// One block of 256 threads owns one (chunk, column tile) pair; per pass of
// 512 entries it stages the (512, BT) products and the row pointers of the
// pass in shared memory, and thread (r, j) adds row r's run of column j in
// slot order into the (r_pad, BT) partial, also in shared memory.  BT keeps
// both tiles and the r_pad + 1 row pointers inside a 64 KB budget.  A fixed
// order of additions, no atomics, bit-identical reruns.
//
// Bound on this card: bytes — the value, lrow and src streams read once,
// X read once and the (C, r_pad, B) partials written once.  Work per chunk
// is O(S·B + r_pad·B); what is left above the bound is the latency of the
// X gathers (a B-float row per entry, scattered over n) and, in a chunk
// that one hub row fills, that row's threads adding S products serially.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmm_onehot(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int nrhs, int bt, int val_bf16,
                                    int idx_i16, void* stream) {
  return launch_chunk_runs(vals, lrow, src, x, out, num_chunks, s, r_pad, n,
                           nrhs, bt, val_bf16, idx_i16, stream);
}
