// K11 — one-hot nnz-split CSRC SpMV partials.
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel of the JAX
// package, which reduces each chunk's products c = vals * x[src] with one
// (S, r_pad) one-hot matrix of lrow: partial[r] = sum_s (lrow[s] == r) c[s].
//
// Ported from that math, not from the mask: K12's row-run body
// (chunk_kernels.cuh, chunk_runs_kernel) at one column.  lrow never
// decreases inside a chunk, so each row's entries are one run.  One block of
// 256 threads owns a chunk; per pass of 512 entries it stages the rounded
// products (__fmul_rn) and the pass's row pointers in shared memory, and the
// thread of row r adds its run in slot order into a running sum that starts
// at 0 and carries across passes.  No mask, no atomics: a fixed order of
// additions, bit-identical reruns, equal bit for bit to K12's column 0 and
// to the scan this kernel used before.  A NaN in x reaches only the rows
// whose entries gather it, where the TPU contraction multiplies it into the
// whole row.
//
// Before: one thread per row compared every staged entry with its row (a
// scan body since removed), S * r_pad compares per chunk — 5.4e9 at the
// random-pattern main shape, 1.351 ms, operations-bound.
//
// Bound on this card: bytes — the value, lrow and src streams read once, x
// read once and the (C, r_pad) partials written once.  Work per chunk is
// O(S + r_pad); what is left above the bound is the latency of the
// scattered x gathers and of each pass's two barriers, and in a chunk that
// one hub row fills, that row's thread adding S products serially.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmv_onehot(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int val_bf16, int idx_i16, void* stream) {
  return launch_chunk_runs(vals, lrow, src, x, out, num_chunks, s, r_pad, n,
                           1, 1, val_bf16, idx_i16, stream);
}
