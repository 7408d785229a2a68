// Shared helpers of the FEM assembly scatter kernels (K13, K14).
//
// Pack geometry (assembly/scatter.py::_pack_colored): per color c a row of
// Lmax entries; entry i scatters contribution kvals[slots[c][i]] into
// out[tgts[c][i]] of the unified [ad | al | au] vector.  Padded entries
// carry slot sentinel num_contribs and target sentinel size: both kernels
// skip any entry outside [0, num_contribs) x [0, size), sentinels included,
// where the TPU bodies gathered an appended zero into a dropped segment.
// Slot and target streams are int16 or int32 each, widened in registers.
#pragma once

#include "blockell_common.cuh"

__device__ __forceinline__ bool in_range(int v, int bound) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(bound);
}

// Instantiate LAUNCH(slot type, target type) for the stream dtypes at hand.
#define ASSEMBLY_DISPATCH(slot_i16, tgt_i16, LAUNCH) \
  do {                                               \
    if (slot_i16) {                                  \
      if (tgt_i16) {                                 \
        LAUNCH(short, short);                        \
      } else {                                       \
        LAUNCH(short, int);                          \
      }                                              \
    } else {                                         \
      if (tgt_i16) {                                 \
        LAUNCH(int, short);                          \
      } else {                                       \
        LAUNCH(int, int);                            \
      }                                              \
    }                                                \
  } while (0)
