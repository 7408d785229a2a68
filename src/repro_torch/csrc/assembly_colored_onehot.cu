// K14 — colored FEM assembly scatter, one-hot form.
//
// Replaces the TPU body kernels/assembly_scatter.py::_colored_kernel_onehot
// of the JAX package: grid (C, NT), program (c, t) contracts the (TILE, L)
// one-hot of color c's tile-local targets with its contributions and adds
// the result into output tile t, revisited across the outer color axis.
// That layout is right only when programs run in order, and its work is
// C * Lmax * NT * TILE compares (about 5e14 at a 393,216-element tet mesh).
// This kernel is ported from the math instead: a one-hot row of tile t only
// matches entries whose target lies in tile t.  The host buckets each
// color's entries by tile once per schedule (order: positions stable-sorted
// by target / TILE; ptr: each tile's range), and one block of TILE threads
// owns output tile t across ALL colors in color order: for each color it
// stages that tile's bucket in shared memory, and the thread of position p
// adds the matching contributions in slot order into a register.  No mask,
// no atomics, a fixed order: reruns are bit-identical, and the whole tile
// is written once (zeros included).
//
// Bound on this card: bytes (the contributions and the three index streams
// read once, the vector written once); the compares, about
// C * (entries per tile bucket) * TILE per tile, cost more than that.
#include "assembly_common.cuh"

namespace {

constexpr int kTile = 512;    // kernels/assembly_scatter.py ONEHOT_TILE
constexpr int kStage = 512;   // bucket entries staged per pass

template <typename S, typename T>
__global__ void __launch_bounds__(kTile)
colored_onehot_kernel(const S* __restrict__ slots, const T* __restrict__ tgts,
                      const int* __restrict__ order,
                      const int* __restrict__ ptr,
                      const float* __restrict__ kvals,
                      float* __restrict__ out, int num_colors, int lmax,
                      int num_tiles, int num_contribs, int size) {
  __shared__ int local[kStage];
  __shared__ float value[kStage];
  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int base = tile * kTile;
  float acc = 0.0f;
  for (int c = 0; c < num_colors; ++c) {
    const size_t row = static_cast<size_t>(c) * lmax;
    const int* tile_ptr = ptr + static_cast<size_t>(c) * (num_tiles + 1);
    const int lo = tile_ptr[tile];
    const int hi = tile_ptr[tile + 1];
    for (int s0 = lo; s0 < hi; s0 += kStage) {
      const int count = min(kStage, hi - s0);
      if (p < count) {
        const size_t e = row + order[row + s0 + p];
        const int s = load_index(slots, e);
        const int t = load_index(tgts, e);
        const bool ok = in_range(s, num_contribs) && in_range(t, size);
        local[p] = ok ? t - base : -1;
        value[p] = ok ? kvals[s] : 0.0f;
      }
      __syncthreads();
      for (int j = 0; j < count; ++j) {
        if (local[j] == p) acc += value[j];
      }
      __syncthreads();
    }
  }
  if (base + p < size) out[base + p] = acc;
}

}  // namespace

extern "C" int assembly_colored_onehot(const void* slots, const void* tgts,
                                       const void* order, const void* ptr,
                                       const void* kvals, void* out,
                                       int num_colors, int lmax,
                                       int num_tiles, int num_contribs,
                                       int size, int slot_i16, int tgt_i16,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(S, T)                                                      \
  colored_onehot_kernel<S, T><<<num_tiles, kTile, 0, st>>>(               \
      static_cast<const S*>(slots), static_cast<const T*>(tgts),          \
      static_cast<const int*>(order), static_cast<const int*>(ptr),       \
      static_cast<const float*>(kvals), static_cast<float*>(out),         \
      num_colors, lmax, num_tiles, num_contribs, size)
  ASSEMBLY_DISPATCH(slot_i16, tgt_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
