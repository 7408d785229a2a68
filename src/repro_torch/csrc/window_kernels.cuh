// The four window kernels of the block-ELL CSRC products, shared by the
// rectangular grid (K1-K4, blockell_*.cu) and the flat grid (K5-K8,
// flat_*.cu).
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
// C entry point of one kernel and its design notes.
#pragma once

#include "blockell_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 512;   // slots staged per pass through shared memory

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
// Streaming SpMV: gather + shared-memory atomic scatter (K1, K5)
// ---------------------------------------------------------------------------

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
  const size_t base = ts.base;
  for (int p = tid; p < ts.count; p += kThreads) {
    const int c = load_index(col, base + p);
    const int r = load_index(row, base + p);
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(w_pad)) continue;
    const float vl = load_value(vals_l, base + p);
    const int cg = min(max(c, 0), w_pad - 1);
    atomicAdd(&acc[r], vl * xw[cg]);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(w_pad)) {
      const float vu = num_sym ? vl : load_value(vals_u, base + p);
      atomicAdd(&acc[c], vu * xw[r]);
    }
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
// Streaming SpMM: (slot, column) work items, B axis in column tiles (K2, K6)
// ---------------------------------------------------------------------------

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
  const int tid = threadIdx.x;
  float* xw = smem;                          // (W, cols) x window
  float* acc = smem + static_cast<size_t>(w_pad) * bt;   // (W, cols)

  const int items_w = w_pad * cols;
  for (int q = tid; q < items_w; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    long long g = window_row(b, tm, w_pad, w, n);
    xw[q] = g >= 0 ? x[static_cast<size_t>(g) * nrhs + j0 + j] : 0.0f;
    acc[q] = 0.0f;
  }
  __syncthreads();

  const TileSlots ts = tiles(b);
  const size_t base = ts.base;
  const long long items_s = static_cast<long long>(ts.count) * cols;
  for (long long q = tid; q < items_s; q += kThreads) {
    const int p = static_cast<int>(q / cols);
    const int j = static_cast<int>(q - static_cast<long long>(p) * cols);
    const int c = load_index(col, base + p);
    const int r = load_index(row, base + p);
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(w_pad)) continue;
    const float vl = load_value(vals_l, base + p);
    const int cg = min(max(c, 0), w_pad - 1);
    atomicAdd(&acc[r * cols + j], vl * xw[cg * cols + j]);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(w_pad)) {
      const float vu = num_sym ? vl : load_value(vals_u, base + p);
      atomicAdd(&acc[c * cols + j], vu * xw[r * cols + j]);
    }
  }
  __syncthreads();

  const int d0 = w_pad - tm;
  const int items_d = tm * cols;
  for (int q = tid; q < items_d; q += kThreads) {
    const int t = q / cols;
    const int j = q - t * cols;
    const int at = (d0 + t) * cols + j;
    acc[at] += load_value(ad, static_cast<size_t>(b) * tm + t) * xw[at];
  }
  __syncthreads();

  float* dst = out + static_cast<size_t>(b) * w_pad * nrhs;
  for (int q = tid; q < items_w; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    dst[static_cast<size_t>(w) * nrhs + j0 + j] = acc[q];
  }
}

template <typename Tiles>
int launch_spmm_stream(const void* vals_l, const void* vals_u,
                       const void* col, const void* row, const void* ad,
                       const void* x, void* out, Tiles tiles, int nt, int tm,
                       int w_pad, int n, int nrhs, int bt, int num_sym,
                       int val_bf16, int idx_i16, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w_pad) * bt * sizeof(float);
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

// ---------------------------------------------------------------------------
// One-hot SpMV: one thread per window position, fixed-order scan (K3, K7)
// ---------------------------------------------------------------------------

template <typename V, typename I, typename Tiles>
__global__ void __launch_bounds__(kThreads)
spmv_onehot_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, Tiles tiles, int k_step, int tm,
                   int w_pad, int n, int num_sym) {
  extern __shared__ float xw[];            // (W,) x window
  __shared__ int2 rc[kChunk];              // (row, col) of the staged slots
  __shared__ float2 lu[kChunk];            // (lower, upper) values
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  for (int w = tid; w < w_pad; w += kThreads) {
    long long g = window_row(b, tm, w_pad, w, n);
    xw[w] = g >= 0 ? x[g] : 0.0f;
  }
  __syncthreads();

  const TileSlots ts = tiles(b);
  const size_t base = ts.base;
  const int s = ts.count;
  const int d0 = w_pad - tm;
  for (int w0 = 0; w0 < w_pad; w0 += kThreads) {
    const int w = w0 + tid;
    const bool active = w < w_pad;
    float result = 0.0f;
    for (int step0 = 0; step0 < s; step0 += k_step) {
      const int step1 = min(step0 + k_step, s);
      float win = 0.0f;
      for (int c0 = step0; c0 < step1; c0 += kChunk) {
        const int len = min(kChunk, step1 - c0);
        __syncthreads();   // the previous chunk has been consumed
        for (int i = tid; i < len; i += kThreads) {
          const size_t p = base + c0 + i;
          const float vl = load_value(vals_l, p);
          rc[i] = make_int2(load_index(row, p), load_index(col, p));
          lu[i] = make_float2(vl, num_sym ? vl : load_value(vals_u, p));
        }
        __syncthreads();
        if (active) {
          for (int i = 0; i < len; ++i) {
            const int2 q = rc[i];
            if (q.x == w) {
              const float xg = static_cast<unsigned>(q.y) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[q.y]
                                   : 0.0f;
              win += lu[i].x * xg;
            }
            if (q.y == w) {
              const float xi = static_cast<unsigned>(q.x) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[q.x]
                                   : 0.0f;
              win += lu[i].y * xi;
            }
          }
        }
      }
      if (step0 == 0) {
        float diag = 0.0f;
        if (active && w >= d0) {
          diag = load_value(ad, static_cast<size_t>(b) * tm + (w - d0)) * xw[w];
        }
        result = diag + win;
      } else {
        result += win;
      }
    }
    if (active) out[static_cast<size_t>(b) * w_pad + w] = result;
  }
}

template <typename Tiles>
int launch_spmv_onehot(const void* vals_l, const void* vals_u,
                       const void* col, const void* row, const void* ad,
                       const void* x, void* out, Tiles tiles, int nt,
                       int k_step, int tm, int w_pad, int n, int num_sym,
                       int val_bf16, int idx_i16, void* stream) {
  const size_t smem = static_cast<size_t>(w_pad) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e =                                                          \
        allow_dynamic_smem(spmv_onehot_kernel<V, I, Tiles>, smem);           \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    spmv_onehot_kernel<V, I, Tiles><<<nt, kThreads, smem, st>>>(             \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),        \
        static_cast<const I*>(col), static_cast<const I*>(row),              \
        static_cast<const V*>(ad), static_cast<const float*>(x),             \
        static_cast<float*>(out), tiles, k_step, tm, w_pad, n, num_sym);     \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// One-hot SpMM: one thread per (window position, column) (K4, K8)
// ---------------------------------------------------------------------------

template <typename V, typename I, typename Tiles>
__global__ void __launch_bounds__(kThreads)
spmm_onehot_kernel(const V* __restrict__ vals_l, const V* __restrict__ vals_u,
                   const I* __restrict__ col, const I* __restrict__ row,
                   const V* __restrict__ ad, const float* __restrict__ x,
                   float* __restrict__ out, Tiles tiles, int k_step, int tm,
                   int w_pad, int n, int nrhs, int bt, int num_sym) {
  extern __shared__ float xw[];            // (W, cols) x window
  __shared__ int2 rc[kChunk];              // (row, col) of the staged slots
  __shared__ float2 lu[kChunk];            // (lower, upper) values
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * bt;
  const int cols = min(bt, nrhs - j0);
  const int tid = threadIdx.x;

  const int items = w_pad * cols;
  for (int q = tid; q < items; q += kThreads) {
    const int w = q / cols;
    const int j = q - w * cols;
    long long g = window_row(b, tm, w_pad, w, n);
    xw[q] = g >= 0 ? x[static_cast<size_t>(g) * nrhs + j0 + j] : 0.0f;
  }
  __syncthreads();

  const TileSlots ts = tiles(b);
  const size_t base = ts.base;
  const int s = ts.count;
  const int d0 = w_pad - tm;
  for (int q0 = 0; q0 < items; q0 += kThreads) {
    const int q = q0 + tid;
    const bool active = q < items;
    const int w = active ? q / cols : -1;
    const int j = active ? q - w * cols : 0;
    float result = 0.0f;
    for (int step0 = 0; step0 < s; step0 += k_step) {
      const int step1 = min(step0 + k_step, s);
      float win = 0.0f;
      for (int c0 = step0; c0 < step1; c0 += kChunk) {
        const int len = min(kChunk, step1 - c0);
        __syncthreads();   // the previous chunk has been consumed
        for (int i = tid; i < len; i += kThreads) {
          const size_t p = base + c0 + i;
          const float vl = load_value(vals_l, p);
          rc[i] = make_int2(load_index(row, p), load_index(col, p));
          lu[i] = make_float2(vl, num_sym ? vl : load_value(vals_u, p));
        }
        __syncthreads();
        if (active) {
          for (int i = 0; i < len; ++i) {
            const int2 m = rc[i];
            if (m.x == w) {
              const float xg = static_cast<unsigned>(m.y) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[m.y * cols + j]
                                   : 0.0f;
              win += lu[i].x * xg;
            }
            if (m.y == w) {
              const float xi = static_cast<unsigned>(m.x) <
                                       static_cast<unsigned>(w_pad)
                                   ? xw[m.x * cols + j]
                                   : 0.0f;
              win += lu[i].y * xi;
            }
          }
        }
      }
      if (step0 == 0) {
        float diag = 0.0f;
        if (active && w >= d0) {
          diag = load_value(ad, static_cast<size_t>(b) * tm + (w - d0)) * xw[q];
        }
        result = diag + win;
      } else {
        result += win;
      }
    }
    if (active) {
      out[(static_cast<size_t>(b) * w_pad + w) * nrhs + j0 + j] = result;
    }
  }
}

template <typename Tiles>
int launch_spmm_onehot(const void* vals_l, const void* vals_u,
                       const void* col, const void* row, const void* ad,
                       const void* x, void* out, Tiles tiles, int nt,
                       int k_step, int tm, int w_pad, int n, int nrhs, int bt,
                       int num_sym, int val_bf16, int idx_i16, void* stream) {
  const size_t smem = static_cast<size_t>(w_pad) * bt * sizeof(float);
  const dim3 grid(nt, (nrhs + bt - 1) / bt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(V, I)                                                         \
  do {                                                                       \
    cudaError_t e =                                                          \
        allow_dynamic_smem(spmm_onehot_kernel<V, I, Tiles>, smem);           \
    if (e != cudaSuccess) return static_cast<int>(e);                        \
    spmm_onehot_kernel<V, I, Tiles><<<grid, kThreads, smem, st>>>(           \
        static_cast<const V*>(vals_l), static_cast<const V*>(vals_u),        \
        static_cast<const I*>(col), static_cast<const I*>(row),              \
        static_cast<const V*>(ad), static_cast<const float*>(x),             \
        static_cast<float*>(out), tiles, k_step, tm, w_pad, n, nrhs, bt,     \
        num_sym);                                                            \
  } while (0)
  BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH);
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
