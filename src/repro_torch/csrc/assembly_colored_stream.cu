// K13 — colored FEM assembly scatter, streaming.
//
// Replaces the TPU body kernels/assembly_scatter.py::_colored_kernel_stream
// of the JAX package: grid (C,), program c gathers color c's contributions
// and segment-sums them by target into the whole output, which the grid
// revisits color after color.  On the TPU the grid runs in order; here the
// colors become serial phases of ONE cooperative launch: every thread
// grid-strides over color c's Lmax entries, then the grid synchronizes
// (cooperative_groups grid barrier) and moves to color c + 1.  The kernel
// zeroes the output itself in a phase 0, so an assembly is one launch.
//
// Inside a greedy color no two elements share a DOF, so every target is
// written once: the add is a plain load-add-store with no atomics (the
// paper's conflict-free discipline).  A RACE level group may share nodes
// inside one color; the wrapper then sets `atomic` and the adds become
// atomicAdd.  The load goes through L2 (__ldcg): another SM may have written
// the word in an earlier color.
//
// The grid is sized to the blocks that fit on the card at once (occupancy x
// SMs); a larger cooperative grid would be refused, and the error code goes
// back to the wrapper, which raises.
//
// Bound on this card: bytes — per entry a 4-byte contribution and the two
// index streams, plus the unified vector written once (it fits in the 50 MB
// L2, where the scattered read-modify-writes land).
#include <cooperative_groups.h>

#include "assembly_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <typename S, typename T, bool kAtomic>
__global__ void __launch_bounds__(kThreads)
colored_stream_kernel(const S* __restrict__ slots, const T* __restrict__ tgts,
                      const float* __restrict__ kvals, float* out,
                      int num_colors, int lmax, int num_contribs, int size) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < size; i += stride) out[i] = 0.0f;
  grid.sync();
  for (int c = 0; c < num_colors; ++c) {
    const size_t row = static_cast<size_t>(c) * lmax;
    for (long long i = first; i < lmax; i += stride) {
      const int s = load_index(slots, row + i);
      const int t = load_index(tgts, row + i);
      if (!in_range(s, num_contribs) || !in_range(t, size)) continue;
      const float v = kvals[s];
      if (kAtomic) {
        atomicAdd(out + t, v);
      } else {
        out[t] = __ldcg(out + t) + v;
      }
    }
    grid.sync();
  }
}

template <typename S, typename T, bool kAtomic>
cudaError_t launch(const void* slots, const void* tgts, const void* kvals,
                   void* out, int num_colors, int lmax, int num_contribs,
                   int size, cudaStream_t stream) {
  auto kernel = colored_stream_kernel<S, T, kAtomic>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const S* s_ = static_cast<const S*>(slots);
  const T* t_ = static_cast<const T*>(tgts);
  const float* k_ = static_cast<const float*>(kvals);
  float* o_ = static_cast<float*>(out);
  void* args[] = {&s_, &t_, &k_, &o_, &num_colors, &lmax, &num_contribs,
                  &size};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(per_sm * sms), dim3(kThreads), args,
                                     0, stream);
}

}  // namespace

extern "C" int assembly_colored_stream(const void* slots, const void* tgts,
                                       const void* kvals, void* out,
                                       int num_colors, int lmax, int atomic,
                                       int num_contribs, int size,
                                       int slot_i16, int tgt_i16,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define LAUNCH(S, T)                                                         \
  err = atomic ? launch<S, T, true>(slots, tgts, kvals, out, num_colors,     \
                                    lmax, num_contribs, size, st)            \
               : launch<S, T, false>(slots, tgts, kvals, out, num_colors,    \
                                     lmax, num_contribs, size, st)
  ASSEMBLY_DISPATCH(slot_i16, tgt_i16, LAUNCH);
#undef LAUNCH
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
