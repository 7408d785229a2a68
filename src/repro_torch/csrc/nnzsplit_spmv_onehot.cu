// K11 — one-hot nnz-split CSRC SpMV partials.
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel of the JAX
// package, which reduces each chunk's products c = vals * x[src] with one
// (S, r_pad) one-hot matrix of lrow: partial[r] = sum_s (lrow[s] == r) c[s].
//
// Ported from that math, not from the mask: one block of 128 threads owns a
// chunk; the chunk's entries are staged 512 at a time in shared memory (lrow
// and the product), and the thread owning row r adds every staged product
// whose lrow equals r, in slot order, into its running sum.  No mask is
// built and no atomic is used, so every run adds in the same order
// (bit-identical reruns), and a NaN in x reaches only the rows whose entries
// gather it, where the TPU contraction multiplies it into the whole row.
//
// Bound on this card: operations — S * r_pad compares per chunk (1,024 x 128
// on a power-law graph) against 12 bytes read per entry.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmv_onehot(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int val_bf16, int idx_i16, void* stream) {
  return launch_chunk_onehot(vals, lrow, src, x, out, num_chunks, s, r_pad, n,
                             1, 1, val_bf16, idx_i16, stream);
}
