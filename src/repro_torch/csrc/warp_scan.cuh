// Warp-segmented sums over runs of equal keys, shared by the stream bodies
// that sum a warp's slots by row before one shared-memory add per run: the
// window stream products (K1, K2, K5, K6: window_kernels.cuh) and the chunk
// stream sums (K9, K10: chunk_kernels.cuh).
//
// The keys must never decrease along the lanes of the warp (lanes below a
// lane that stores, at least): then two lanes 2^i apart with equal keys
// bound a run, and the Hillis-Steele scan below adds inside runs only.
// Every lane of the warp must call both helpers, whether it stores or not.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// Runs of equal keys in a warp whose keys never decrease along the lanes.
// Bit i of `add` says: at scan step 2^i, the lane 2^i below holds the same
// key; `tail` marks the last lane of each run.
struct WarpRuns {
  unsigned add;
  bool tail;
};

__device__ __forceinline__ WarpRuns warp_runs(int key) {
  const int lane = threadIdx.x & 31;
  unsigned add = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int d = 1 << i;
    const int below = __shfl_up_sync(kFullWarp, key, d);
    if (lane >= d && below == key) add |= 1u << i;
  }
  const int above = __shfl_down_sync(kFullWarp, key, 1);
  return {add, lane == 31 || above != key};
}

// Inclusive scan of v inside each run (Hillis-Steele): on a run's tail lane
// the result is the run's sum.  All 32 lanes must call it.
__device__ __forceinline__ float run_sum(WarpRuns runs, float v) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float below = __shfl_up_sync(kFullWarp, v, 1 << i);
    if ((runs.add >> i) & 1u) v += below;
  }
  return v;
}

}  // namespace
