// K14 — colored FEM assembly scatter, one-hot form.
//
// Replaces the TPU body kernels/assembly_scatter.py::_colored_kernel_onehot
// of the JAX package: grid (C, NT), program (c, t) contracts the (TILE, L)
// one-hot of color c's tile-local targets with its contributions and adds
// the result `win` into output tile t (`out += win`), revisited across the
// outer color axis.  That layout is right only when programs run in order,
// and its work is C * Lmax * NT * TILE compares.  This kernel is ported
// from the math instead: a one-hot row of tile t only matches entries whose
// target lies in tile t, and in a bucket sorted by target each position's
// matches are one run.
//
// The host derives the buckets once per schedule (pack_colored_streams):
// color c's pack entries stable-sorted by target, sentinels last, as two
// streams (bucket_slots[c], bucket_tgts[c]) that ptr[c] cuts into tiles, so
// each (color, tile) bucket is a contiguous range whose targets never
// decrease, ties in slot order.  One block owns output tile t across ALL
// colors:
//
//   staging  the tile's buckets of up to kGroup colors are laid end to end
//            in color order (their sizes come from ptr, prefix-summed by
//            one warp) and staged kStage entries per pass as (tile-local
//            target, contribution): contiguous reads of the two bucket
//            streams, then the gather of kvals, kBatch loads in flight per
//            thread, so the load chain ptr -> streams -> kvals is paid once
//            per pass for many colors, not once per color;
//   runs     per color, the entry that opens a run (first of its bucket, or
//            a target other than its predecessor's) sums its run in slot
//            order from 0 and adds the sum into acc[local] in shared
//            memory — the body's `win`, then `out += win`.  Runs of one
//            color have distinct targets, so its adds never collide; one
//            barrier separates colors.  A run cut by the end of a pass is
//            carried (target, partial sum) into the next pass and continued
//            there, so it is still added once;
//   write    the tile, zeros included, once and coalesced where base + p <
//            size.
//
// Order of additions, per target: colors in color order; within a color
// the run's sum in slot order, then one add — the TPU body's order.  On a
// greedy coloring every run is one entry long (no color repeats a target).
// No atomics and one fixed order: reruns are bit-identical.
//
// Bound on this card: bytes — each real entry's slot, target and
// contribution read once, the vector written once (plus the layout's
// `ptr`).  Work per (color, tile) is O(bucket + TILE / colors) instead of
// bucket * TILE compares.  Buckets sorted by target read the pack's entries
// out of element order: read through a permutation, the slot and target
// loads were scattered too, so the host stores them permuted.  An
// element's contributions land in many tiles, so a tile's kvals reads stay
// scattered 4-byte loads, a 32-byte sector each: that gather, not the adds,
// sets the time.  kStage 2,048 (18.7 KB of shared memory) lets 8 blocks of
// 256 threads share an SM.
#include "assembly_common.cuh"

namespace {

constexpr int kTile = 512;      // kernels/assembly_scatter.py ONEHOT_TILE
constexpr int kThreads = 256;   // two output positions per thread
constexpr int kStage = 2048;    // bucket entries staged per pass
constexpr int kGroup = 32;      // colors per staging table (one warp's scan)
constexpr int kBatch = 4;       // gathers per thread in flight
constexpr unsigned kFullWarp = 0xffffffffu;

// Stages entries [g0, g0 + len) of the group's concatenated buckets: color
// l of the group owns [off[l], off[l + 1]), its entry g sits at position
// lo[l] + g - off[l] of its bucket row.  An entry outside [0, G) x tile
// (which a valid pack never holds) is staged as target -1, value 0.
template <typename S, typename T>
__device__ __forceinline__ void stage_entries(
    const S* __restrict__ slots, const T* __restrict__ tgts,
    const float* __restrict__ kvals,
    const int* lo, const int* off, int cg, int ng, int g0, int len, int base,
    int lmax, int num_contribs, int size, int* local, float* value) {
  for (int j0 = 0; j0 < len; j0 += kThreads * kBatch) {
    long long e[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads + threadIdx.x;
      e[u] = -1;
      if (j < len) {
        const int g = g0 + j;
        int l = 0;   // the last color of the group whose bucket starts <= g
#pragma unroll
        for (int step = kGroup / 2; step > 0; step >>= 1) {
          if (l + step < ng && off[l + step] <= g) l += step;
        }
        e[u] = static_cast<long long>(cg + l) * lmax + lo[l] + (g - off[l]);
      }
    }
    int s[kBatch], t[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      s[u] = -1;
      t[u] = -1;
      if (e[u] >= 0) {
        s[u] = load_index(slots, static_cast<size_t>(e[u]));
        t[u] = load_index(tgts, static_cast<size_t>(e[u]));
      }
    }
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool ok = in_range(s[u], num_contribs) && in_range(t[u], size) &&
                      in_range(t[u] - base, kTile);
      t[u] = ok ? t[u] - base : -1;
      v[u] = ok ? kvals[s[u]] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * kThreads + threadIdx.x;
      if (j < len) {
        local[j] = t[u];
        value[j] = v[u];
      }
    }
  }
}

template <typename S, typename T>
__global__ void __launch_bounds__(kThreads)
colored_runs_kernel(const S* __restrict__ slots, const T* __restrict__ tgts,
                    const int* __restrict__ ptr,
                    const float* __restrict__ kvals,
                    float* __restrict__ out, int num_colors, int lmax,
                    int num_tiles, int num_contribs, int size) {
  __shared__ float acc[kTile];
  __shared__ int local[kStage];      // staged tile-local targets
  __shared__ float value[kStage];    // staged contributions
  __shared__ int lo[kGroup];         // group color l's bucket: row
  __shared__ int off[kGroup + 1];    // positions lo[l].., entries off[l]..
  __shared__ int carry_local[2];     // a run cut by the end of a pass:
  __shared__ float carry_sum[2];     // written to one slot, read from the
                                     // other by the next pass
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int base = tile * kTile;
  for (int p = tid; p < kTile; p += kThreads) acc[p] = 0.0f;
  int parity = 0;

  for (int cg = 0; cg < num_colors; cg += kGroup) {
    const int ng = min(kGroup, num_colors - cg);
    __syncthreads();   // acc is zeroed; the previous group's table is read
    if (tid < 32) {
      int first = 0;
      int count = 0;
      if (tid < ng) {
        const int* row = ptr + static_cast<size_t>(cg + tid) * (num_tiles + 1);
        first = row[tile];
        count = max(0, row[tile + 1] - first);
      }
      int incl = count;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFullWarp, incl, d);
        if (tid >= d) incl += y;
      }
      lo[tid] = first;
      off[tid] = incl - count;
      if (tid == 31) off[kGroup] = incl;
    }
    __syncthreads();
    const int total = off[kGroup];

    // the last color of a pass ends with a barrier after its adds, so the
    // next pass may overwrite the staged entries at once
    for (int g0 = 0; g0 < total; g0 += kStage) {
      const int len = min(kStage, total - g0);
      stage_entries(slots, tgts, kvals, lo, off, cg, ng, g0, len,
                    base, lmax, num_contribs, size, local, value);
      __syncthreads();
      for (int l = 0; l < ng; ++l) {
        const int a = max(off[l], g0) - g0;
        const int b = min(off[l + 1], g0 + len) - g0;
        if (a >= b) continue;                   // uniform: no barrier
        const bool cont = a == 0 && off[l] < g0;        // from the last pass
        const bool more = g0 + b < off[l + 1];          // into the next one
        for (int j = a + tid; j < b; j += kThreads) {
          const int loc = local[j];
          float sum = 0.0f;
          if (j == a && cont) {
            const int carried = carry_local[parity];
            if (loc == carried) {
              sum = carry_sum[parity];          // continue the cut run
            } else if (carried >= 0) {
              acc[carried] += carry_sum[parity];   // it ended at the cut
            }
          } else if (j > a && local[j - 1] == loc) {
            continue;                           // its run's opener adds it
          }
          int k = j;
          do {
            sum += value[k];
          } while (++k < b && local[k] == loc);
          if (k == b && more) {
            carry_local[parity ^ 1] = loc;
            carry_sum[parity ^ 1] = sum;
          } else if (loc >= 0) {
            acc[loc] += sum;
          }
        }
        __syncthreads();   // color l's adds land before color l + 1's
      }
      parity ^= 1;
    }
  }
  __syncthreads();
  for (int p = tid; p < kTile; p += kThreads) {
    if (base + p < size) out[base + p] = acc[p];
  }
}

}  // namespace

extern "C" int assembly_colored_onehot(const void* bucket_slots,
                                       const void* bucket_tgts,
                                       const void* ptr, const void* kvals,
                                       void* out,
                                       int num_colors, int lmax,
                                       int num_tiles, int num_contribs,
                                       int size, int slot_i16, int tgt_i16,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(S, T)                                                      \
  colored_runs_kernel<S, T><<<num_tiles, kThreads, 0, st>>>(              \
      static_cast<const S*>(bucket_slots),                                \
      static_cast<const T*>(bucket_tgts), static_cast<const int*>(ptr),   \
      static_cast<const float*>(kvals), static_cast<float*>(out),         \
      num_colors, lmax, num_tiles, num_contribs, size)
  ASSEMBLY_DISPATCH(slot_i16, tgt_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
