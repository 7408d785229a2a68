// Shared helpers of the block-ELL window kernels.
//
// Pack geometry (core/blockell.py): NT row tiles of TM rows, S slots per
// tile, a W-wide window per tile that ends at the tile's last row.  Window
// position w of tile b is row (b+1)*TM - W + w of the matrix; positions that
// fall before row 0 or past row n-1 read x as 0, which replaces the padded
// copy of x the TPU kernels slice.  Padded slots carry value 0, the column
// sentinel W and the row W-1.
//
// Value streams are float32 or bfloat16, index streams int32 or int16; both
// are widened in registers and every product and sum is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ float load_value(const T* p, size_t i);

template <>
__device__ __forceinline__ float load_value<float>(const float* p, size_t i) {
  return p[i];
}

template <>
__device__ __forceinline__ float load_value<__nv_bfloat16>(
    const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename I>
__device__ __forceinline__ int load_index(const I* p, size_t i) {
  return static_cast<int>(p[i]);
}

// Row of the matrix behind window position w of tile b, or -1 outside [0, n).
__device__ __forceinline__ long long window_row(int b, int tm, int w_pad,
                                                int w, int n) {
  long long g = static_cast<long long>(b + 1) * tm - w_pad + w;
  return (g >= 0 && g < n) ? g : -1;
}

// Instantiate LAUNCH(value type, index type) for the stream dtypes at hand.
#define BLOCKELL_DISPATCH(val_bf16, idx_i16, LAUNCH)  \
  do {                                                \
    if (val_bf16) {                                   \
      if (idx_i16) {                                  \
        LAUNCH(__nv_bfloat16, short);                 \
      } else {                                        \
        LAUNCH(__nv_bfloat16, int);                   \
      }                                               \
    } else {                                          \
      if (idx_i16) {                                  \
        LAUNCH(float, short);                         \
      } else {                                        \
        LAUNCH(float, int);                           \
      }                                               \
    }                                                 \
  } while (0)

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
inline cudaError_t allow_dynamic_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
