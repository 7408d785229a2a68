// K9 — streaming nnz-split CSRC SpMV partials.
//
// Replaces the TPU body kernels/csrc_spmv_nnzsplit.py::_kernel_stream of the
// JAX package: per chunk, c = vals * x[src] over the chunk's S entries,
// segment-summed by the chunk-local row lrow into an r_pad-wide partial;
// (C, r_pad) out.  The TPU version gathers x[src] outside the kernel into a
// stream as long as the pack; here the gather happens in the kernel (x is
// 8 MB at n = 2,097,152 and stays in the 50 MB L2).
//
// One block of 128 threads owns one chunk (1,024 entries at ks = 8), the
// partial row in shared memory.  The stream is sorted by row, so the 32
// entries a warp reads in one step form a few runs of equal lrow (about 32
// entries per row of a power-law graph, thousands on a hub row): a
// shuffle-based scan sums each run inside the warp and only the run's last
// lane adds into shared memory.  That replaces the 32-way collisions of a
// shared-memory atomic per entry (what kept K5 at 4x its bound) with at
// most one atomic per run and warp; the remaining atomics order the adds
// of different warps from run to run (exact on dyadic data).  The chunk's
// whole partial row, zeros included, is written out coalesced.
//
// Bound on this card: bytes — each entry reads a value, lrow and src
// (12 bytes at float32/int32) and one 4-byte x element from L2.
#include "chunk_kernels.cuh"

extern "C" int nnzsplit_spmv_stream(const void* vals, const void* lrow,
                                    const void* src, const void* x, void* out,
                                    int num_chunks, int s, int r_pad, int n,
                                    int val_bf16, int idx_i16, void* stream) {
  return launch_chunk_stream<false>(vals, lrow, src, x, out, num_chunks, s,
                                    r_pad, n, 1, 1, val_bf16, idx_i16,
                                    stream);
}
