// K10 — streaming nnz-split CSRC SpMM partials (B right-hand sides).
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel_mm_stream of
// the JAX package: K9 (nnzsplit_spmv_stream.cu) for X of shape (n, B) — per
// entry the row X[src, :] times the value, segment-summed by lrow into a
// (r_pad, B) partial; (C, r_pad, B) out.  The TPU version gathers X[src]
// outside the kernel; here the gather happens in the kernel.
//
// One block owns one (chunk, column tile) pair: the B axis is cut into
// column tiles of BT columns so that the (r_pad, BT) accumulator stays under
// a 64 KB shared-memory budget (grid.y).  A thread loads an entry's value,
// lrow and src once; the warp's run structure (which lanes share a row) is
// computed once per step and reused for every column, so each column costs
// five shuffles and one atomic per run.  Before the sums the warp copies its
// 32 entries' X rows into a per-warp shared buffer with the column fastest
// (chunk_kernels.cuh, kStaged), so a load instruction reads a few whole
// rows: gathering one column at a time sent each load to 32 rows of X and
// read a row's 4·B bytes in B separate loads (measured against that form:
// tools/k6k10_body_probe.py, PERF.md).
//
// Bound on this card: bytes.  The streams amortize over the B columns, but
// each entry reads a 4·B-byte row of X: at B = 11 and n = 2,097,152, X is
// 92 MB, larger than the 50 MB L2.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmm_stream(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int nrhs, int bt, int val_bf16,
                                    int idx_i16, void* stream) {
  return launch_chunk_stream<true>(vals, lrow, src, x, out, num_chunks, s,
                                   r_pad, n, nrhs, bt, val_bf16, idx_i16,
                                   stream);
}
