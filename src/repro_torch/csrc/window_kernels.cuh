// The stream bodies of the block-ELL CSRC window products — K1/K2 on the
// rectangular grid (blockell_*_stream.cu), K5/K6 on the flat grid
// (flat_*_stream.cu) — and the tile maps both grids share with the one-hot
// kernels' run-and-bucket body (window_runs.cuh: K3/K4, K7/K8).
//
// Both grids compute, per row tile b, the W-wide output window of the tile
// from the slots the tile owns; they differ only in which slots those are:
//
//   RectTiles  every tile owns S slots, tile b the slots [b*S, (b+1)*S)
//   FlatTiles  tile b owns the k-steps [step_start[b], step_start[b+1]) of
//              `step` slots each, so a dense tile carries many steps and a
//              sparse one a single step (no padding to the densest tile)
//
// One block owns one tile and loops over its slots; each .cu file holds the
// C entry point of one kernel and its design notes.  Both bodies (SpMV: K1,
// K5; SpMM: K2, K6) sum a warp's slots by row, so they need the row order
// that blockell.check_slot_order checks wherever a pack is built, loaded or
// converted: rows never decrease inside a tile or a k-step.
#pragma once

#include "blockell_common.cuh"
#include "warp_scan.cuh"

namespace {

constexpr int kThreads = 256;

// Slots [base, base + count) of the streams belong to one row tile.
struct TileSlots {
  size_t base;
  int count;
};

struct RectTiles {
  int s;
  __device__ __forceinline__ TileSlots operator()(int b) const {
    return {static_cast<size_t>(b) * s, s};
  }
};

struct FlatTiles {
  const int* step_start;   // (NT+1,) first k-step of each tile
  int step;                // slots per k-step
  __device__ __forceinline__ TileSlots operator()(int b) const {
    const int j0 = step_start[b];
    return {static_cast<size_t>(j0) * step, (step_start[b + 1] - j0) * step};
  }
};

// ---------------------------------------------------------------------------
// Streaming SpMV: gather, row runs summed per lane and warp, shared adds
// (K1, K5)
// ---------------------------------------------------------------------------
//
// A lane takes kLaneSlots consecutive slots per pass (one 16-byte load of
// each 32-bit stream, 8 bytes of a 16-bit one), a warp 128, a block 1,024.
// Rows never decrease inside a tile (rectangular) or a k-step (flat) —
// checked wherever a pack is built, loaded or converted
// (blockell.check_slot_order) — and a tile's slot count and the step are
// multiples of 128 (checked by the wrappers), so every warp is whole or
// idle and its 128 slots never cross a step.  Row half al*x[col]: a lane
// sums its slots' products by row in slot order; a run that ends inside the
// lane is added into the window at once, and the lane's last run goes
// through the warp's segmented scan keyed by its row (warp_scan.cuh), whose
// last lane adds the sum.  So a row gets one shared add per warp piece and
// at most one more, where one add per slot put all 32 lanes of a warp on
// one word on a long row.  Column half au*x[row]: one add per slot, a row's
// columns are distinct.  On a long row they are consecutive, so in slot
// order lanes L, L+8, L+16 and L+24 would add into one bank at once; lane
// L takes its four slots in the order j ^ ((L >> 3) & 3) instead, which
// puts the 32 adds in 32 banks.  A slot whose row lies outside [0, W) (no
// checked pack holds one) adds nothing.

constexpr int kLaneSlots = 4;

// Slots [i, i + 4) of a stream, i a multiple of 4, widened to 32 bits.
__device__ __forceinline__ void load4(const float* p, size_t i, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p + i);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, size_t i,
                                      float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p + i);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void load4(const int* p, size_t i, int (&v)[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p + i);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const short* p, size_t i, int (&v)[4]) {
  const short4 q = *reinterpret_cast<const short4*>(p + i);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// Element i of four registers; i differs between lanes, so this is a
// chain of selects rather than an indexed (local-memory) array.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

template <typename V, typename I, typename Tiles>
__global__ void __launch_bounds__(kThreads)
spmv_stream_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, Tiles tiles, int tm, int w_pad,
                   int n, int num_sym) {
  extern __shared__ float smem[];
  float* xw = smem;            // (W,) x window
  float* acc = smem + w_pad;   // (W,) output window
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int w = tid; w < w_pad; w += kThreads) {
    long long g = window_row(b, tm, w_pad, w, n);
    xw[w] = g >= 0 ? x[g] : 0.0f;
    acc[w] = 0.0f;
  }
  __syncthreads();

  const TileSlots ts = tiles(b);
  const int swizzle = (tid >> 3) & 3;
  for (int q = tid * kLaneSlots; q < ts.count; q += kThreads * kLaneSlots) {
    const size_t at = ts.base + q;
    int cs[kLaneSlots], rs[kLaneSlots];
    float ls[kLaneSlots], us[kLaneSlots];
    load4(col, at, cs);
    load4(row, at, rs);
    load4(vals_l, at, ls);
    if (num_sym) {
#pragma unroll
      for (int i = 0; i < kLaneSlots; ++i) us[i] = ls[i];
    } else {
      load4(vals_u, at, us);
    }
    int key = -1;        // the row of the run being summed, -1 for none
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < kLaneSlots; ++i) {
      const int k =
          static_cast<unsigned>(rs[i]) < static_cast<unsigned>(w_pad) ? rs[i]
                                                                      : -1;
      if (k != key) {    // the run of `key` ends inside the lane
        if (key >= 0) atomicAdd(&acc[key], run);
        key = k;
        run = 0.0f;
      }
      run += ls[i] * xw[min(max(cs[i], 0), w_pad - 1)];
    }
#pragma unroll
    for (int j = 0; j < kLaneSlots; ++j) {
      const int i = j ^ swizzle;
      const int r = pick(rs, i);
      const int c = pick(cs, i);
      if (static_cast<unsigned>(r) < static_cast<unsigned>(w_pad) &&
          static_cast<unsigned>(c) < static_cast<unsigned>(w_pad)) {
        atomicAdd(&acc[c], pick(us, i) * xw[r]);
      }
    }
    const WarpRuns runs = warp_runs(key);
    const float sum = run_sum(runs, run);
    if (key >= 0 && runs.tail) atomicAdd(&acc[key], sum);
  }
  __syncthreads();

  const int d0 = w_pad - tm;   // tile rows are the last TM window positions
  for (int t = tid; t < tm; t += kThreads) {
    acc[d0 + t] += load_value(ad, static_cast<size_t>(b) * tm + t) * xw[d0 + t];
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(b) * w_pad;
  for (int w = tid; w < w_pad; w += kThreads) dst[w] = acc[w];
}

template <typename Tiles>
int launch_spmv_stream(const void* vals_l, const void* vals_u,
                       const void* col, const void* row, const void* ad,
                       const void* x, void* out, Tiles tiles, int nt, int tm,
                       int w_pad, int n, int num_sym, int val_bf16,
                       int idx_i16, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w_pad) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e =                                                          \
        allow_dynamic_smem(spmv_stream_kernel<V, I, Tiles>, smem);           \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    spmv_stream_kernel<V, I, Tiles><<<nt, kThreads, smem, st>>>(             \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),        \
        static_cast<const I*>(col), static_cast<const I*>(row),              \
        static_cast<const V*>(ad), static_cast<const float*>(x),             \
        static_cast<float*>(out), tiles, tm, w_pad, n, num_sym);             \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Streaming SpMM: K1/K5's lanes and warp runs, once per column (K2, K6)
// ---------------------------------------------------------------------------
//
// One block owns one (row tile, column tile) pair: the B axis is cut into
// column tiles of BT columns (grid.y) so that the (W, BT) x window and
// accumulator fit the shared-memory budget.  Both are laid out row by row
// with an odd row stride ld = BT | 1 (one word of padding for an even BT).
// The slots are read as in K1/K5: a lane loads kLaneSlots consecutive slots
// of each stream once per pass, and the warp's run structure (warp_runs,
// keyed by the row of each lane's last run) is computed once per pass.
// Then, for each column j of the tile:
//
//   row half     al*x[col, j] summed by row over the lane's slots in slot
//                order; a run that ends inside the lane is added at once,
//                the lane's last run goes through the warp's segmented scan
//                and its run's tail lane adds the sum: one shared add per
//                run piece and column;
//   column half  au*x[row, j] -> [col, j], one add per slot, in the
//                swizzled slot order j' ^ ((L >> 3) & 3) of K1/K5.  On a
//                long row lanes L and L+8 hold columns 32 apart, words
//                32*ld apart: with ld odd the swizzle's offsets 0-3 rows put
//                the 32 adds in 32 banks for every BT.
//
// A shared float atomicAdd is a compare-and-swap loop on sm_90a, so
// the adds are what the body spends: per (slot, column) one on the column
// half, and on the row half one per run piece instead of one per slot,
// where a wide row's lanes would meet on its few words.  Sentinels, bounds
// and the diagonal as in K1/K5.

template <typename V, typename I, typename Tiles>
__global__ void __launch_bounds__(kThreads)
spmm_stream_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, Tiles tiles, int tm, int w_pad,
                   int n, int nrhs, int bt, int num_sym) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * bt;           // first column of this tile
  const int cols = min(bt, nrhs - j0);      // columns in this tile
  const int ld = bt | 1;                    // odd row stride of both windows
  const int tid = threadIdx.x;
  float* xw = smem;                                    // (W, ld) x window
  float* acc = smem + static_cast<size_t>(w_pad) * ld;  // (W, ld) output

  const int items_w = w_pad * cols;
  for (int q = tid; q < items_w; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    long long g = window_row(b, tm, w_pad, w, n);
    xw[w * ld + j] = g >= 0 ? x[static_cast<size_t>(g) * nrhs + j0 + j] : 0.0f;
    acc[w * ld + j] = 0.0f;
  }
  __syncthreads();

  const TileSlots ts = tiles(b);
  const int swizzle = (tid >> 3) & 3;
  for (int q = tid * kLaneSlots; q < ts.count; q += kThreads * kLaneSlots) {
    const size_t at = ts.base + q;
    int cs[kLaneSlots], rs[kLaneSlots];
    float ls[kLaneSlots], us[kLaneSlots];
    load4(col, at, cs);
    load4(row, at, rs);
    load4(vals_l, at, ls);
    if (num_sym) {
#pragma unroll
      for (int i = 0; i < kLaneSlots; ++i) us[i] = ls[i];
    } else {
      load4(vals_u, at, us);
    }
    // Row half: each slot's row key (-1 outside the window) and gather
    // offset; column half: target and source offsets in swizzled order,
    // -1 for a slot that adds nothing.
    int keys[kLaneSlots], gat[kLaneSlots], tgt[kLaneSlots], srcw[kLaneSlots];
    float vu[kLaneSlots];
#pragma unroll
    for (int i = 0; i < kLaneSlots; ++i) {
      keys[i] = static_cast<unsigned>(rs[i]) < static_cast<unsigned>(w_pad)
                    ? rs[i]
                    : -1;
      gat[i] = min(max(cs[i], 0), w_pad - 1) * ld;
    }
#pragma unroll
    for (int k = 0; k < kLaneSlots; ++k) {
      const int i = k ^ swizzle;
      const int r = pick(rs, i);
      const int c = pick(cs, i);
      const bool adds =
          static_cast<unsigned>(r) < static_cast<unsigned>(w_pad) &&
          static_cast<unsigned>(c) < static_cast<unsigned>(w_pad);
      tgt[k] = adds ? c * ld : -1;
      srcw[k] = adds ? r * ld : 0;
      vu[k] = pick(us, i);
    }
    const int key = keys[kLaneSlots - 1];   // the row of the lane's last run
    const WarpRuns runs = warp_runs(key);
    for (int j = 0; j < cols; ++j) {
      int k_run = -1;
      float run = 0.0f;
#pragma unroll
      for (int i = 0; i < kLaneSlots; ++i) {
        if (keys[i] != k_run) {   // the run of k_run ends inside the lane
          if (k_run >= 0) atomicAdd(&acc[k_run * ld + j], run);
          k_run = keys[i];
          run = 0.0f;
        }
        run += ls[i] * xw[gat[i] + j];
      }
#pragma unroll
      for (int k = 0; k < kLaneSlots; ++k) {
        if (tgt[k] >= 0) atomicAdd(&acc[tgt[k] + j], vu[k] * xw[srcw[k] + j]);
      }
      const float sum = run_sum(runs, run);
      if (key >= 0 && runs.tail) atomicAdd(&acc[key * ld + j], sum);
    }
  }
  __syncthreads();

  const int d0 = w_pad - tm;
  const int items_d = tm * cols;
  for (int q = tid; q < items_d; q += kThreads) {
    const int t = q / cols;
    const int j = q - t * cols;
    const int at = (d0 + t) * ld + j;
    acc[at] += load_value(ad, static_cast<size_t>(b) * tm + t) * xw[at];
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(b) * w_pad * nrhs;
  for (int q = tid; q < items_w; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    dst[static_cast<size_t>(w) * nrhs + j0 + j] = acc[w * ld + j];
  }
}

template <typename Tiles>
int launch_spmm_stream(const void* vals_l, const void* vals_u,
                       const void* col, const void* row, const void* ad,
                       const void* x, void* out, Tiles tiles, int nt, int tm,
                       int w_pad, int n, int nrhs, int bt, int num_sym,
                       int val_bf16, int idx_i16, void* stream) {
  const size_t smem =
      2 * static_cast<size_t>(w_pad) * (bt | 1) * sizeof(float);
  const dim3 grid(nt, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e =                                                          \
        allow_dynamic_smem(spmm_stream_kernel<V, I, Tiles>, smem);           \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    spmm_stream_kernel<V, I, Tiles><<<grid, kThreads, smem, st>>>(           \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),        \
        static_cast<const I*>(col), static_cast<const I*>(row),              \
        static_cast<const V*>(ad), static_cast<const float*>(x),             \
        static_cast<float*>(out), tiles, tm, w_pad, n, nrhs, bt, num_sym);   \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
