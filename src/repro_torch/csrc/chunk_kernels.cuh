// The four chunk kernels of the nnz-split CSRC products (K9-K12,
// nnzsplit_*.cu).
//
// Pack geometry (kernels/csrc_spmv_nnzsplit.py): the combined stream of 2k
// entries (lower slot (i, j) gives dest i / src j / al and dest j / src i /
// au), sorted by dest and cut into C chunks of S = ks*128 entries.  Entry e
// of chunk c stores its value, its chunk-local row lrow (dest minus the
// chunk's first row, below r_pad) and its gather index src.  Padding
// entries carry value 0, src 0 and the stream's last row, so they add
// 0 * x[0] to that row, as in the JAX package.
//
// Every kernel writes the chunk's whole (r_pad, B) partial, zeros included,
// as one coalesced row of the (C, r_pad, B) output: the fix-up that merges
// rows split across chunks reads exactly that.  x (n, B) is gathered inside
// the kernel, read as 0 for an index outside [0, n), which a valid pack
// never holds.  Values are float32 or bfloat16, indices int32 or int16,
// both widened in registers; every product and sum is float32.
//
// One block owns one (chunk, column tile) pair: grid (C, ceil(B / BT)).
//
// Bodies: the warp-segmented stream sums (K9, K10) and the row-run sums of
// the one-hot products (K12, and K11 as its one-column instance).
#pragma once

#include "blockell_common.cuh"
#include "warp_scan.cuh"   // WarpRuns, warp_runs, run_sum, kFullWarp

namespace {

constexpr int kChunkThreads = 128;   // S and r_pad are multiples of 128
constexpr int kStage = 512;          // entries staged per pass (one-hot)

__device__ __forceinline__ float gather_x(const float* __restrict__ x,
                                          int g, int n, int nrhs, int j) {
  return static_cast<unsigned>(g) < static_cast<unsigned>(n)
             ? x[static_cast<size_t>(g) * nrhs + j]
             : 0.0f;
}

// ---------------------------------------------------------------------------
// Streaming: warp-segmented sums by lrow into a shared-memory row (K9, K10)
// ---------------------------------------------------------------------------
//
// A thread loads one entry's value, lrow and src per step of 32 entries a
// warp; the warp's runs of equal lrow (warp_runs) are found once per step
// and every column's products go through the segmented scan (run_sum), the
// run's tail lane adding the sum into the (r_pad, cols) accumulator.
//
// How x arrives differs.  K9 (kStaged false, one column) gathers x[src]
// directly, one 4-byte load per lane.  K10 (kStaged true) first copies the
// warp's 32 X rows into a per-warp (32, ld) buffer in shared memory, ld =
// cols | 1: the lanes walk the (entry, column) pairs with the column
// fastest, taking each entry's src from its lane by shuffle, so one load
// instruction reads a few whole rows of X instead of one float from each of
// 32 rows.  After __syncwarp lane e reads row e, conflict-free at an odd
// stride, and runs the same products and scan as the direct gather, so both
// forms give the same sums.

template <typename V, typename I, bool kStaged>
__global__ void __launch_bounds__(kChunkThreads)
chunk_stream_kernel(const V* __restrict__ vals, const I* __restrict__ lrow,
                    const I* __restrict__ src, const float* __restrict__ x,
                    float* __restrict__ out, int s, int r_pad, int n,
                    int nrhs, int bt) {
  extern __shared__ float smem[];
  float* acc = smem;                       // (r_pad, cols)
  const int c = blockIdx.x;
  const int j0 = blockIdx.y * bt;
  const int cols = min(bt, nrhs - j0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int items = r_pad * cols;
  for (int q = tid; q < items; q += kChunkThreads) acc[q] = 0.0f;
  // K10: this warp's (32, ld) buffer, and the lane's first (entry, column)
  // pair of a copy and the step of 32 pairs in entries and columns
  const int ld = cols | 1;
  float* buf = smem + static_cast<size_t>(r_pad) * bt +
               static_cast<size_t>(tid >> 5) * 32 * (bt | 1);
  const int e_first = lane / cols;
  const int j_first = lane - e_first * cols;
  const int de = 32 / cols;
  const int dj = 32 - de * cols;
  __syncthreads();

  // s is a multiple of 128, so every warp is either whole or idle
  const size_t base = static_cast<size_t>(c) * s;
  for (int e = tid; e < s; e += kChunkThreads) {
    const int key = load_index(lrow, base + e);
    const float v = load_value(vals, base + e);
    const int g = load_index(src, base + e);
    const WarpRuns runs = warp_runs(key);
    const bool store =
        runs.tail && static_cast<unsigned>(key) < static_cast<unsigned>(r_pad);
    if constexpr (kStaged) {
      __syncwarp();                       // the last step's reads are done
      int se = e_first, sj = j_first;
      for (int t = 0; t < cols; ++t) {    // 32 * cols pairs, cols per lane
        const int gs = __shfl_sync(kFullWarp, g, se);
        buf[se * ld + sj] = gather_x(x, gs, n, nrhs, j0 + sj);
        se += de;
        sj += dj;
        if (sj >= cols) {
          sj -= cols;
          ++se;
        }
      }
      __syncwarp();
      for (int j = 0; j < cols; ++j) {
        const float sum = run_sum(runs, v * buf[lane * ld + j]);
        if (store) atomicAdd(&acc[key * cols + j], sum);
      }
    } else {
      for (int j = 0; j < cols; ++j) {
        const float sum = run_sum(runs, v * gather_x(x, g, n, nrhs, j0 + j));
        if (store) atomicAdd(&acc[key * cols + j], sum);
      }
    }
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(c) * r_pad * nrhs;
  for (int q = tid; q < items; q += kChunkThreads) {
    const int r = q / cols;
    const int j = q - r * cols;
    dst[static_cast<size_t>(r) * nrhs + j0 + j] = acc[q];
  }
}

template <bool kStaged>
int launch_chunk_stream(const void* vals, const void* lrow, const void* src,
                        const void* x, void* out, int num_chunks, int s,
                        int r_pad, int n, int nrhs, int bt, int val_bf16,
                        int idx_i16, void* stream) {
  // the (r_pad, BT) accumulator and, for K10, one (32, BT | 1) buffer a warp
  const size_t buffers =
      kStaged ? static_cast<size_t>(kChunkThreads) * (bt | 1) : 0;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(r_pad) * bt + buffers);
  const dim3 grid(num_chunks, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e =                                                          \
        allow_dynamic_smem(chunk_stream_kernel<V, I, kStaged>, smem);        \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    chunk_stream_kernel<V, I, kStaged><<<grid, kChunkThreads, smem, st>>>(   \
        static_cast<const V*>(vals), static_cast<const I*>(lrow),            \
        static_cast<const I*>(src), static_cast<const float*>(x),            \
        static_cast<float*>(out), s, r_pad, n, nrhs, bt);                    \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// One-hot products: one thread per (row, column) sums its row's run (K11 at
// B = BT = 1, K12)
// ---------------------------------------------------------------------------
//
// The TPU bodies contract the (S, r_pad) one-hot of lrow with the chunk's
// (S, B) products.  lrow never decreases inside a chunk (checked wherever a
// pack is built, loaded or converted: check_chunk_streams), so row r's
// entries are one run, and padding (value 0, src 0, the stream's last row)
// sits inside that row's run, adding 0·x[0] as in the reference.  Per pass
// of kStage entries:
//
//   products      one per (entry, column), rounded (__fmul_rn: never fused
//                 into a sum), columns fastest, so consecutive threads read
//                 consecutive columns of one X row;
//   row pointers  the entry whose row differs from its predecessor's writes
//                 start[r] = its index for every row r from the
//                 predecessor's row + 1 to its own; the last entry closes
//                 the rows after its own.  Row r's run is [start[r],
//                 start[r + 1]), empty for a row without entries.  No
//                 zeroing, one writer per row;
//   sums          thread (r, j) adds its run's products of column j, in slot
//                 order, into its running sum in shared memory, which
//                 starts at 0 — a run cut by the end of a pass continues in
//                 the next one unchanged.
//
// Each row's sum is its entries' rounded products in slot order from 0, the
// order of the fixed-order scan that K11 and K12 used before (one thread
// per row comparing every entry of the chunk with its row), so K11 equals
// K12's column 0 and both equal that scan bit for bit.  Work per chunk:
// O(S·B + r_pad·B) against the scan's S·r_pad·B compares.  An lrow outside
// [0, r_pad), which a checked pack never holds, joins no run.

constexpr int kRunThreads = 256;

__device__ __forceinline__ int run_key(int key, int r_pad) {
  return key < 0 ? -1 : min(key, r_pad);
}

template <typename V, typename I>
__global__ void __launch_bounds__(kRunThreads)
chunk_runs_kernel(const V* __restrict__ vals, const I* __restrict__ lrow,
                  const I* __restrict__ src, const float* __restrict__ x,
                  float* __restrict__ out, int s, int r_pad, int n, int nrhs,
                  int bt) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int j0 = blockIdx.y * bt;
  const int cols = min(bt, nrhs - j0);
  const int tid = threadIdx.x;
  const int items = r_pad * cols;
  float* acc = smem;                                        // (r_pad, cols)
  float* prod = smem + static_cast<size_t>(r_pad) * bt;     // (kStage, cols)
  int* start = reinterpret_cast<int*>(prod + static_cast<size_t>(kStage) *
                                                 bt);       // (r_pad + 1,)
  for (int q = tid; q < items; q += kRunThreads) acc[q] = 0.0f;

  const size_t base = static_cast<size_t>(c) * s;
  for (int e0 = 0; e0 < s; e0 += kStage) {
    const int len = min(kStage, s - e0);
    __syncthreads();   // the previous pass has been consumed
    for (int i = tid; i < len * cols; i += kRunThreads) {
      const int e = i / cols;
      const int j = i - e * cols;
      const size_t p = base + e0 + e;
      prod[i] = __fmul_rn(load_value(vals, p),
                          gather_x(x, load_index(src, p), n, nrhs, j0 + j));
    }
    for (int i = tid; i < len; i += kRunThreads) {
      const size_t p = base + e0 + i;
      const int key = run_key(load_index(lrow, p), r_pad);
      const int prev = i == 0 ? -1 : run_key(load_index(lrow, p - 1), r_pad);
      for (int r = prev + 1; r <= key; ++r) start[r] = i;
      if (i == len - 1) {
        for (int r = max(key, prev) + 1; r <= r_pad; ++r) start[r] = len;
      }
    }
    __syncthreads();
    for (int q = tid; q < items; q += kRunThreads) {
      const int r = q / cols;
      const int j = q - r * cols;
      float a = acc[q];
      const int k1 = min(start[r + 1], len);   // in range for any lrow
      for (int k = max(start[r], 0); k < k1; ++k) a += prod[k * cols + j];
      acc[q] = a;
    }
  }

  // each thread stores the items it summed
  float* dst = out + static_cast<size_t>(c) * r_pad * nrhs;
  for (int q = tid; q < items; q += kRunThreads) {
    const int r = q / cols;
    const int j = q - r * cols;
    dst[static_cast<size_t>(r) * nrhs + j0 + j] = acc[q];
  }
}

inline size_t chunk_runs_smem_bytes(int r_pad, int bt) {
  return sizeof(float) * ((static_cast<size_t>(r_pad) + kStage) * bt +
                          r_pad + 1);
}

inline int launch_chunk_runs(const void* vals, const void* lrow,
                             const void* src, const void* x, void* out,
                             int num_chunks, int s, int r_pad, int n,
                             int nrhs, int bt, int val_bf16, int idx_i16,
                             void* stream) {
  if (bt < 1 || nrhs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = chunk_runs_smem_bytes(r_pad, bt);
  const dim3 grid(num_chunks, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e = allow_dynamic_smem(chunk_runs_kernel<V, I>, smem);       \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    chunk_runs_kernel<V, I><<<grid, kRunThreads, smem, st>>>(                \
        static_cast<const V*>(vals), static_cast<const I*>(lrow),            \
        static_cast<const I*>(src), static_cast<const float*>(x),            \
        static_cast<float*>(out), s, r_pad, n, nrhs, bt);                    \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
