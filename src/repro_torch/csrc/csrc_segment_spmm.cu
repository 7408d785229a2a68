// K15 — the whole CSRC product Y = A·X in one pass: the `segment` path on
// the card, for X (m, B) row-major float32, B >= 1.
//
// Replaces no TPU body.  The JAX package's `segment` path,
// kernels/ref.py::csrc_spmm (csrc_spmv_arrays for one column), is plain jnp:
// two gathers, two multiplies and two segment sums, which XLA fuses on the
// TPU.  Carried over as PyTorch calls, the chain wrote each gather as a
// (k, B) array, read it back to multiply and again to `index_add_` by int64
// ids widened on every call.  On the 112^3 HPCG cube at B = 8 (k = 17.9 M)
// that was 25.1 ms a product, 21.6 ms of it in PyTorch's gather, which
// takes one thread block per 32-byte row.  This kernel is added so that the
// segment path — every square matrix whose window exceeds w_cap, and every
// rectangular one — keeps no per-slot product in device memory.
//
// Design.  A group of `lanes` consecutive threads owns row i; each lane
// takes a column group of V consecutive columns (V = 4: 16-byte loads and
// reductions; V = 2 or 1 where B or the pointers' alignment do not allow
// 4), and lane l takes groups l, l + lanes, ...  The wrapper picks V and
// lanes = min(B / V, 32) from X's width: B = 1 is one lane a row, B = 8 two
// lanes of 16 bytes.  For each of its groups the lane walks the row's slots
// in order and
//   - sums ad[i]·X[i] + Σ al[p]·X[ja[p]] (+ the rectangular tail's
//     ar[q]·X[n + jar[q]]) in registers: the gather term, owned by the row;
//   - adds au[p]·X[i] to Y[ja[p]] by a fire-and-forget reduction
//     (`red.global.add.v4.f32` / `.v2.f32`, sm_90; scalar `atomicAdd`, whose
//     unused result makes it a `red`, for V = 1): the transpose term, whose
//     destination rows belong to other groups.
// The owned sum joins Y[i] by the same reduction when the row is done, into
// a Y the entry point zeroes on the stream first.  So the destination's
// thread safety comes from the L2's atomic units, where the paper used
// per-thread buffers or a colouring.  On a stencil, neighbouring rows at
// the same slot position gather from and scatter to neighbouring rows, so a
// warp's gathers and reductions coalesce.  Indices are read as stored
// (int32), nothing is widened, and an index outside the matrix adds nothing
// (ROADMAP C7).  With numerically symmetric values al serves both halves
// and au is not read.
//
// Heavy rows.  A lane group walks its row's slots one after another, and a
// block ends with its longest row.  On a power-law graph (a Graph500
// Kronecker graph at SCALE 21: lower rows of 15 slots on average, the
// longest 68,862) one row would keep its block running long after every
// other row is done.  So the wrapper marks, once per bound matrix, each
// row with more than `heavy` lower slots and cuts its slots into chunks of
// consecutive slots (a table of (row, first slot, end slot) on the card).
// Where the table is empty — every row short, as on HPCG's stencil — the
// product is segment_kernel alone, as above.  Otherwise it is two launches:
// segment_light_kernel, the same row-owned walk in which a heavy row keeps
// only its diagonal and tail, then segment_chunk_kernel, in which a lane
// group takes one chunk, sums its gather terms in registers and joins them
// to Y[row] by the same reduction, its transpose terms going to Y[ja[p]]
// as before.  Every lane group then walks at most max(heavy, chunk) slots.
// A chunk's lane loads kBatch slots' X rows before it reduces any of them,
// since its gathers are random where a stencil's coalesce.  On that graph at
// B = 8 (heavy 16, chunk 256: 205,107 rows, 90 % of the slots, in 265,233
// chunks; H100 80GB HBM3, 700 W) the product takes 1.11 ms against 24.4 ms
// unsplit; kBatch 8 against 1 gains 11 %, 16 loses to register pressure,
// and thresholds of 4-64 and chunks of 128-512 lie within 10 % of it
// (tools/k15_split_probe.py).  Its chunks' random 32-byte gathers and
// reductions, about 2.8 GB of sectors, set that time more than the slots'
// count does.
//
// Bound on this card: bytes — ia, ja, al (au unless symmetric) and ad read
// once, X read and Y written once: about 245 MB at the cube's B = 8 (the
// benchmark's count, without ia, is 239 MB: 0.071 ms at 3.35 TB/s) and
// 166 MB at B = 1.  Above it the design pays X's rows re-read through L1 / L2
// (each row is gathered by its 26 neighbours' groups), Y's zeroing, and the
// L2 throughput of k + n reductions of V floats each per column group: 36 M
// vector reductions at the cube's B = 8, 19 M scalar ones at B = 1.  On an
// H100 80GB HBM3 at 700 W the cube's product takes 0.279 ms at B = 8 (3.8x
// the bound; the chain took 25.1 ms) and 0.110 ms at B = 1 (2.2x; the chain
// 0.89 ms).  Of the other lane mappings at B = 8, (2, 4) is 2 % slower,
// (1, 8) 16 % and one lane walking both groups 85 %; evict-first loads of
// ja / al lose 1.3-3.6x, since a warp's rows reread their index sectors from
// L1 across the row's slots (tools/k15_body_probe.py).
//
// Summation order: float32 throughout.  The reductions land in atomic
// order, so Y can differ from run to run by rounding (exact on dyadic
// values; ROADMAP C44), as the `index_add_` it replaces did; a heavy row's
// gather term is a sum of its chunks' partial sums, in that order too.  A
// float `red` add flushes subnormal inputs and results to zero (PTX ISA), as
// `index_add_`'s atomics on the card do.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V>
struct Cols {
  float v[V];
};

template <int V>
__device__ __forceinline__ Cols<V> load_cols(const float* p) {
  Cols<V> c;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    c.v[0] = t.x;
    c.v[1] = t.y;
    c.v[2] = t.z;
    c.v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    c.v[0] = t.x;
    c.v[1] = t.y;
  } else {
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int V>
__device__ __forceinline__ void red_add(float* p, const Cols<V>& c) {
  if constexpr (V == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(p), "f"(c.v[0]), "f"(c.v[1]), "f"(c.v[2]),
                   "f"(c.v[3])
                 : "memory");
  } else if constexpr (V == 2) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
                 :
                 : "l"(p), "f"(c.v[0]), "f"(c.v[1])
                 : "memory");
  } else {
    atomicAdd(p, c.v[0]);
  }
}

// One column group of row i over slots [p0, p1): al[p]·X[ja[p]] into the
// owned sum `acc`, au[p]·X[i] into Y[ja[p]] by reduction.  The row-owned
// kernels and the chunk kernel walk their slots with it.
template <int V, bool SYM>
__device__ __forceinline__ void walk_slots(
    const int* __restrict__ ja, const float* __restrict__ al,
    const float* __restrict__ au, const float* __restrict__ x, float* y,
    int n, int nrhs, size_t col, const Cols<V>& xi, int p0, int p1,
    Cols<V>& acc) {
  for (int p = p0; p < p1; ++p) {
    const int j = __ldg(ja + p);
    if (static_cast<unsigned>(j) >= static_cast<unsigned>(n)) continue;
    const float a = __ldg(al + p);
    const float u = SYM ? a : __ldg(au + p);
    const size_t at = static_cast<size_t>(j) * nrhs + col;
    const Cols<V> xj = load_cols<V>(x + at);
    Cols<V> t;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc.v[v] = fmaf(a, xj.v[v], acc.v[v]);
      t.v[v] = u * xi.v[v];
    }
    red_add<V>(y + at, t);
  }
}

// A lane group owns row i: its diagonal, its lower slots (SPLIT: none of
// them where the row has more than `heavy`, whose chunks walk them) and its
// rectangular tail.
template <int V, bool SYM, bool TAIL, bool SPLIT>
__device__ __forceinline__ void own_rows(
    const int* __restrict__ ia, const int* __restrict__ ja,
    const float* __restrict__ al, const float* __restrict__ au,
    const float* __restrict__ ad, const int* __restrict__ iar,
    const int* __restrict__ jar, const float* __restrict__ ar,
    const float* __restrict__ x, float* y, int n, int m, int nrhs,
    int lanes, int heavy) {
  const int rows_per_block = kThreads / lanes;
  const int r = threadIdx.x / lanes;
  if (r >= rows_per_block) return;
  const long long i =
      static_cast<long long>(blockIdx.x) * rows_per_block + r;
  if (i >= n) return;
  const int groups = nrhs / V;
  const int p0 = __ldg(ia + i);
  int p1 = __ldg(ia + i + 1);
  if (SPLIT && p1 - p0 > heavy) p1 = p0;
  const int q0 = TAIL ? __ldg(iar + i) : 0;
  const int q1 = TAIL ? __ldg(iar + i + 1) : 0;
  const unsigned tail_cols = static_cast<unsigned>(m - n);
  const float d = __ldg(ad + i);
  const size_t row = static_cast<size_t>(i) * nrhs;
  for (int g = threadIdx.x - r * lanes; g < groups; g += lanes) {
    const size_t col = static_cast<size_t>(g) * V;
    const Cols<V> xi = load_cols<V>(x + row + col);
    Cols<V> acc;
#pragma unroll
    for (int v = 0; v < V; ++v) acc.v[v] = d * xi.v[v];
    walk_slots<V, SYM>(ja, al, au, x, y, n, nrhs, col, xi, p0, p1, acc);
    if (TAIL) {
      for (int q = q0; q < q1; ++q) {
        const int c = __ldg(jar + q);
        if (static_cast<unsigned>(c) >= tail_cols) continue;
        const float a = __ldg(ar + q);
        const Cols<V> xc = load_cols<V>(
            x + (static_cast<size_t>(n) + c) * nrhs + col);
#pragma unroll
        for (int v = 0; v < V; ++v) acc.v[v] = fmaf(a, xc.v[v], acc.v[v]);
      }
    }
    red_add<V>(y + row + col, acc);
  }
}

// Every row owned whole: the product of a matrix without heavy rows.
template <int V, bool SYM, bool TAIL>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const int* __restrict__ ia, const int* __restrict__ ja,
               const float* __restrict__ al, const float* __restrict__ au,
               const float* __restrict__ ad, const int* __restrict__ iar,
               const int* __restrict__ jar, const float* __restrict__ ar,
               const float* __restrict__ x, float* y, int n, int m,
               int nrhs, int lanes) {
  own_rows<V, SYM, TAIL, false>(ia, ja, al, au, ad, iar, jar, ar, x, y, n,
                                m, nrhs, lanes, 0);
}

// The row-owned launch beside the chunk kernel: a heavy row keeps only its
// diagonal and tail here.
template <int V, bool SYM, bool TAIL>
__global__ void __launch_bounds__(kThreads)
segment_light_kernel(const int* __restrict__ ia, const int* __restrict__ ja,
                     const float* __restrict__ al,
                     const float* __restrict__ au,
                     const float* __restrict__ ad,
                     const int* __restrict__ iar,
                     const int* __restrict__ jar,
                     const float* __restrict__ ar,
                     const float* __restrict__ x, float* y, int n, int m,
                     int nrhs, int lanes, int heavy) {
  own_rows<V, SYM, TAIL, true>(ia, ja, al, au, ad, iar, jar, ar, x, y, n,
                               m, nrhs, lanes, heavy);
}

// walk_slots over a chunk, kBatch slots at a time: their indices and
// values, then their kBatch gathers of X, then the sums and reductions, so
// that a lane has kBatch gathers in flight where walk_slots has one (each
// reduction is a memory barrier to the compiler, so it cannot hoist the
// next slot's gather above it).  The owned sum adds in slot order, as in
// walk_slots; the last chunk % kBatch slots go through walk_slots.
constexpr int kBatch = 8;

template <int V, bool SYM>
__device__ __forceinline__ void walk_chunk(
    const int* __restrict__ ja, const float* __restrict__ al,
    const float* __restrict__ au, const float* __restrict__ x, float* y,
    int n, int nrhs, size_t col, const Cols<V>& xi, int p0, int p1,
    Cols<V>& acc) {
  int p = p0;
  for (; p + kBatch <= p1; p += kBatch) {
    int j[kBatch];
    float a[kBatch], u[kBatch];
    Cols<V> xj[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      j[b] = __ldg(ja + p + b);
      a[b] = __ldg(al + p + b);
      u[b] = SYM ? a[b] : __ldg(au + p + b);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (static_cast<unsigned>(j[b]) < static_cast<unsigned>(n)) {
        xj[b] = load_cols<V>(x + static_cast<size_t>(j[b]) * nrhs + col);
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (static_cast<unsigned>(j[b]) >= static_cast<unsigned>(n)) continue;
      Cols<V> t;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc.v[v] = fmaf(a[b], xj[b].v[v], acc.v[v]);
        t.v[v] = u[b] * xi.v[v];
      }
      red_add<V>(y + static_cast<size_t>(j[b]) * nrhs + col, t);
    }
  }
  walk_slots<V, SYM>(ja, al, au, x, y, n, nrhs, col, xi, p, p1, acc);
}

// A lane group takes one chunk (row, first slot, end slot) of a heavy row:
// its slots' gather terms summed in registers and joined to Y[row] by one
// reduction, their transpose terms into Y[ja[p]] as the row kernels do.
template <int V, bool SYM>
__global__ void __launch_bounds__(kThreads)
segment_chunk_kernel(const int* __restrict__ chunks, int n_chunks,
                     const int* __restrict__ ja,
                     const float* __restrict__ al,
                     const float* __restrict__ au,
                     const float* __restrict__ x, float* y, int n, int nrhs,
                     int lanes) {
  const int per_block = kThreads / lanes;
  const int r = threadIdx.x / lanes;
  if (r >= per_block) return;
  const long long c = static_cast<long long>(blockIdx.x) * per_block + r;
  if (c >= n_chunks) return;
  const int i = __ldg(chunks + 3 * c);
  const int p0 = __ldg(chunks + 3 * c + 1), p1 = __ldg(chunks + 3 * c + 2);
  const int groups = nrhs / V;
  const size_t row = static_cast<size_t>(i) * nrhs;
  for (int g = threadIdx.x - r * lanes; g < groups; g += lanes) {
    const size_t col = static_cast<size_t>(g) * V;
    const Cols<V> xi = load_cols<V>(x + row + col);
    Cols<V> acc;
#pragma unroll
    for (int v = 0; v < V; ++v) acc.v[v] = 0.0f;
    walk_chunk<V, SYM>(ja, al, au, x, y, n, nrhs, col, xi, p0, p1, acc);
    red_add<V>(y + row + col, acc);
  }
}

unsigned blocks_for(long long items, int lanes) {
  const int per_block = kThreads / lanes;
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <int V, bool SYM, bool TAIL>
cudaError_t launch(const void* ia, const void* ja, const void* al,
                   const void* au, const void* ad, const void* iar,
                   const void* jar, const void* ar, const void* x, void* y,
                   int n, int m, int nrhs, int lanes, const void* chunks,
                   int n_chunks, int heavy, cudaStream_t stream) {
  const auto* ia_ = static_cast<const int*>(ia);
  const auto* ja_ = static_cast<const int*>(ja);
  const auto* al_ = static_cast<const float*>(al);
  const auto* au_ = static_cast<const float*>(au);
  const auto* ad_ = static_cast<const float*>(ad);
  const auto* iar_ = static_cast<const int*>(iar);
  const auto* jar_ = static_cast<const int*>(jar);
  const auto* ar_ = static_cast<const float*>(ar);
  const auto* x_ = static_cast<const float*>(x);
  auto* y_ = static_cast<float*>(y);
  const unsigned rows = blocks_for(n, lanes);
  if (n_chunks == 0) {
    segment_kernel<V, SYM, TAIL><<<rows, kThreads, 0, stream>>>(
        ia_, ja_, al_, au_, ad_, iar_, jar_, ar_, x_, y_, n, m, nrhs, lanes);
    return cudaGetLastError();
  }
  segment_light_kernel<V, SYM, TAIL><<<rows, kThreads, 0, stream>>>(
      ia_, ja_, al_, au_, ad_, iar_, jar_, ar_, x_, y_, n, m, nrhs, lanes,
      heavy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_chunk_kernel<V, SYM>
      <<<blocks_for(n_chunks, lanes), kThreads, 0, stream>>>(
          static_cast<const int*>(chunks), n_chunks, ja_, al_, au_, x_, y_,
          n, nrhs, lanes);
  return cudaGetLastError();
}

template <int V>
cudaError_t dispatch(bool sym, bool tail, const void* ia, const void* ja,
                     const void* al, const void* au, const void* ad,
                     const void* iar, const void* jar, const void* ar,
                     const void* x, void* y, int n, int m, int nrhs,
                     int lanes, const void* chunks, int n_chunks, int heavy,
                     cudaStream_t stream) {
#define K15_LAUNCH(S, T) \
  return launch<V, S, T>(ia, ja, al, au, ad, iar, jar, ar, x, y, n, m, nrhs, \
                         lanes, chunks, n_chunks, heavy, stream)
  if (sym) {
    if (tail) K15_LAUNCH(true, true);
    K15_LAUNCH(true, false);
  }
  if (tail) K15_LAUNCH(false, true);
  K15_LAUNCH(false, false);
#undef K15_LAUNCH
}

}  // namespace

// Y (n, nrhs) = A·X for X (m, nrhs), both row-major float32; ia / iar
// (n + 1) and ja (k) / jar (kr) int32, al / au (k), ad (n), ar (kr) float32.
// `vec` (1, 2 or 4) columns a lane's group, dividing nrhs, with X and Y
// aligned to 4·vec bytes; `lanes` (1-32) threads a row.  `chunks` holds
// `n_chunks` int32 triples (row, first slot, end slot) that cover the lower
// slots of every row with more than `heavy` of them, and no other slot.
// Zeroes Y on the stream, then launches segment_kernel once where
// n_chunks is 0, else segment_light_kernel and segment_chunk_kernel.
extern "C" int csrc_segment_spmm(const void* ia, const void* ja,
                                 const void* al, const void* au,
                                 const void* ad, const void* iar,
                                 const void* jar, const void* ar,
                                 const void* x, void* y, int n, int m,
                                 int nrhs, int vec, int lanes,
                                 int num_symmetric, int has_tail,
                                 const void* chunks, int n_chunks, int heavy,
                                 void* stream) {
  if (n < 0 || m < n || nrhs < 1 || lanes < 1 || lanes > 32 ||
      (vec != 1 && vec != 2 && vec != 4) || nrhs % vec != 0 ||
      n_chunks < 0 || heavy < 0 || (n_chunks > 0 && chunks == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      y, 0, static_cast<size_t>(n) * nrhs * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool sym = num_symmetric != 0, tail = has_tail != 0;
  if (vec == 4) {
    err = dispatch<4>(sym, tail, ia, ja, al, au, ad, iar, jar, ar, x, y, n,
                      m, nrhs, lanes, chunks, n_chunks, heavy, st);
  } else if (vec == 2) {
    err = dispatch<2>(sym, tail, ia, ja, al, au, ad, iar, jar, ar, x, y, n,
                      m, nrhs, lanes, chunks, n_chunks, heavy, st);
  } else {
    err = dispatch<1>(sym, tail, ia, ja, al, au, ad, iar, jar, ar, x, y, n,
                      m, nrhs, lanes, chunks, n_chunks, heavy, st);
  }
  return static_cast<int>(err);
}
