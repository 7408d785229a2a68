// K13 — colored FEM assembly scatter, streaming.
//
// Replaces the TPU body kernels/assembly_scatter.py::_colored_kernel_stream
// of the JAX package: grid (C,), program c gathers color c's contributions
// and segment-sums them by target into the whole output, which the grid
// revisits color after color.  On the TPU the grid runs in order; here each
// color is one ordinary launch on the caller's stream, one thread per pack
// entry, and stream order keeps the colors in order.  The wrapper hands in
// a zeroed output (torch.zeros); one call launches the C colors.
//
// Every add is a fire-and-forget `red.global.add.f32` (atomicAdd with its
// result unused): nothing waits for the word's old value.  Inside a greedy
// color no two elements share a DOF, so a target takes at most one add per
// color, and the colors run in order, so each target's adds land in color
// order — the TPU body's order, bit for bit.  A RACE level group may repeat
// a target inside one color; those adds land in atomic order (exact on
// dyadic data).  Like every float `red`/`atom` add, this one flushes
// subnormal inputs and results to zero (PTX ISA); stiffness contributions
// are never subnormal, and the plain version's `index_add_` on the card does
// the same.
//
// The slot, target and contribution loads are cache-streaming (__ldcs:
// evict first), so the 0.68 GB that an assembly reads once does not push out
// of L2 the 36.7 MB vector that every color's adds sweep.  Consecutive
// threads take consecutive entries, so each warp's loads and adds cover 32
// consecutive entries of the element-major pack (a few sectors of each
// stream, nearly contiguous contributions).
//
// Before: one cooperative launch, a load-add-store per entry in greedy
// colors (`out[t] = __ldcg(out + t) + v`: an L2 round trip the store waited
// on), a grid barrier after an in-kernel zeroing and after every color —
// 1.228 ms at the full tet mesh.  tools/k13_launch_probe.py times the
// same body behind grid barriers, with grouped loads and without the
// streaming hint.
//
// Bound on this card: bytes — per entry a 4-byte contribution and the two
// index streams, plus the unified vector written once; what is left above
// it is the L2 throughput of 56.6 M scattered adds, each color's a sweep
// over the whole vector (the library's index_add_ takes the elements in
// mesh order instead).
#include "assembly_common.cuh"

namespace {

constexpr int kThreads = 256;

// Entry i of one color's row: its contribution added at its target; a
// sentinel (or any index out of range) adds nothing.
template <typename S, typename T>
__device__ __forceinline__ void add_entry(const S* __restrict__ slots,
                                          const T* __restrict__ tgts,
                                          const float* __restrict__ kvals,
                                          float* out, long long i,
                                          int num_contribs, int size) {
  const int s = __ldcs(slots + i);
  const int t = __ldcs(tgts + i);
  if (in_range(s, num_contribs) && in_range(t, size)) {
    atomicAdd(out + t, __ldcs(kvals + s));
  }
}

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
color_stream_kernel(const S* __restrict__ slots, const T* __restrict__ tgts,
                    const float* __restrict__ kvals, float* out, int lmax,
                    int num_contribs, int size) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < lmax) add_entry(slots, tgts, kvals, out, i, num_contribs, size);
}

template <typename S, typename T>
cudaError_t launch_colors(const void* slots, const void* tgts,
                          const void* kvals, void* out, int num_colors,
                          int lmax, int num_contribs, int size,
                          cudaStream_t stream) {
  const int blocks = (lmax + kThreads - 1) / kThreads;
  for (int c = 0; c < num_colors; ++c) {
    const size_t row = static_cast<size_t>(c) * lmax;
    color_stream_kernel<S, T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(slots) + row, static_cast<const T*>(tgts) + row,
        static_cast<const float*>(kvals), static_cast<float*>(out), lmax,
        num_contribs, size);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int assembly_colored_stream(const void* slots, const void* tgts,
                                       const void* kvals, void* out,
                                       int num_colors, int lmax,
                                       int num_contribs, int size,
                                       int slot_i16, int tgt_i16,
                                       void* stream) {
  if (lmax < 1) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define LAUNCH(S, T)                                                       \
  err = launch_colors<S, T>(slots, tgts, kvals, out, num_colors, lmax,     \
                            num_contribs, size, st)
  ASSEMBLY_DISPATCH(slot_i16, tgt_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(err);
}
