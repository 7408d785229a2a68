#!/usr/bin/env python3
"""K9's stream SpMV body against its candidate forms, with two floors, at
the main path's shape.

    python3 tools/k9_body_probe.py [--n 2097152] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds ``chip_smoke.py``'s ``pl_sym``
(power-law graph, nnz-split pack at ks 8: 1,024-entry chunks, r_pad 128)
with dyadic values, holds every checked form against the plain version
exactly on dyadic x, then times each with CUDA events, medians of four
turns:

  shipped     K9 as it ships (csrc/chunk_kernels.cuh, chunk_stream_kernel
              with kStaged false): one entry per thread and step, the
              gather x[src] right after the three loads, the warp's runs
              of equal lrow summed by shuffles before one shared add per
              run, one chunk per block of 128 threads;
  four        four consecutive entries per lane in one vector load of each
              stream, the lane's four gathers issued before any is used,
              its products summed by lrow in entry order (a run that ends
              inside the lane added at once, its last run through the
              warp's segmented scan), one chunk per block of 128 threads;
  four_cs     ``four`` with the streams read evict-first (``__ldcs``) and
              x through the read-only path (``__ldg``);
  four_cs_el  ``four_cs`` with x read under an L2 evict-last policy
              (``createpolicy`` + ``ld.global.L2::cache_hint``) instead;
  four_multi_t{T}_g{G}
              ``four_cs`` with blocks of T threads walking G consecutive
              chunks, their partial rows zeroed and written once, and the
              next pass's entries loaded before this pass's sums;
  four_multi_t{T}_g{G}_r32
              the same held to 32 registers a thread by its launch bounds
              (16 blocks of 128 or 8 of 256 an SM: every thread slot);
  four_multi_t{T}_g{G}_l1, _c0, _l1_c0
              the same with the streams not allocated in L1
              (``ld.global.nc.L1::no_allocate``) and x kept last in L1
              (``ld.global.nc.L1::evict_last``) (_l1), launched with the
              largest L1 (shared-memory carveout 0: _c0), or both.

Floors, timed and not checked (blocks of 128 threads over 8 chunks, the
loads of ``four_multi``):

  stream_only  the three streams read and the partials written with the
               same sums, no gather: the product takes x[chunk_row0 +
               lrow], a read of x in row order (``src`` is read and only
               tested);
  gather_only  ``src`` read and x[src] gathered and summed per lane, one
               float written per thread: no lrow, no values, no scan, no
               shared adds; ``gather_only_l1_c0`` with the L1 hints and
               the largest L1 of ``_l1_c0``; ``gather_only_hot`` with the
               same loads sent into x[src & 16383], 64 KB of x that L1
               holds (what the gathers cost when they leave L2 alone).

Prints one JSON line: per form its median ms, the four turns, and its rate
over the kernel's bytes (streams, partials and x once), beside the byte
bound at 3.35 TB/s, each kernel's registers a thread (``cuobjdump
-res-usage``) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include "chunk_kernels.cuh"

namespace {

// How a form reads four consecutive entries of a stream in one 16-byte
// load: 0 a plain load, 1 evict-first (__ldcs), 2 not allocated in L1
// (ld.global.nc.L1::no_allocate).
template <int kStream>
__device__ __forceinline__ void lanes4(const float* p, size_t i,
                                       float (&v)[4]) {
  const float4* a = reinterpret_cast<const float4*>(p + i);
  if constexpr (kStream == 2) {
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "l"(a));
  } else {
    const float4 q = kStream == 1 ? __ldcs(a) : *a;
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
}

template <int kStream>
__device__ __forceinline__ void lanes4(const int* p, size_t i, int (&v)[4]) {
  const int4* a = reinterpret_cast<const int4*>(p + i);
  if constexpr (kStream == 2) {
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3]) : "l"(a));
  } else {
    const int4 q = kStream == 1 ? __ldcs(a) : *a;
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
}

// How a form reads x: 0 a plain load, 1 the read-only path, 2 an L2
// evict-last policy, 3 the read-only path kept last in L1
// (ld.global.nc.L1::evict_last).
template <int kX>
__device__ __forceinline__ float load_x(const float* __restrict__ x, int g,
                                        int n, unsigned long long policy) {
  if (static_cast<unsigned>(g) >= static_cast<unsigned>(n)) return 0.0f;
  if constexpr (kX == 0) {
    return x[g];
  } else if constexpr (kX == 1) {
    return __ldg(x + g);
  } else if constexpr (kX == 2) {
    float v;
    asm("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v) : "l"(x + g), "l"(policy));
    return v;
  } else {
    float v;
    asm("ld.global.nc.L1::evict_last.f32 %0, [%1];" : "=f"(v) : "l"(x + g));
    return v;
  }
}

// The candidate forms: kT threads a block, kStream and kX the reads of the
// streams and of x, kPrefetch the next pass's loads before this pass's
// sums, kGather false for the stream_only floor (x[chunk_row0 + lrow]; src
// is read but only tested), kMinBlocks the blocks an SM must hold (a
// register cap; 1 leaves it to the compiler), kCarve the shared-memory
// carveout the launch asks for (-1 the default, 0 the most L1).
template <int kT, int kStream, int kX, bool kPrefetch, bool kGather,
          int kMinBlocks, int kCarve>
__global__ void __launch_bounds__(kT, kMinBlocks)
four_kernel(const float* __restrict__ vals, const int* __restrict__ lrow,
            const int* __restrict__ src, const int* __restrict__ row0s,
            const float* __restrict__ x, float* __restrict__ out,
            int num_chunks, int s, int r_pad, int n, int group) {
  extern __shared__ float acc[];
  unsigned long long policy = 0;
  if constexpr (kX == 2) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  }
  const int c0 = blockIdx.x * group;
  const int chunks = min(group, num_chunks - c0);
  const int items = chunks * r_pad;
  const int count = chunks * s;
  const size_t base = static_cast<size_t>(c0) * s;
  constexpr int kPass = kT * 4;
  for (int q = threadIdx.x; q < items; q += kT) acc[q] = 0.0f;
  __syncthreads();
  int q = threadIdx.x * 4;
  float v[4];
  int r[4], g[4];
  if (q < count) {
    lanes4<kStream>(vals, base + q, v);
    lanes4<kStream>(lrow, base + q, r);
    lanes4<kStream>(src, base + q, g);
  }
  for (; q < count; q += kPass) {
    float xs[4];
    if constexpr (kGather) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xs[i] = load_x<kX>(x, g[i], n, policy);
    } else {
      const int row0 = row0s[c0 + q / s];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xs[i] = g[i] < 0 ? 0.0f : load_x<kX>(x, row0 + r[i], n, policy);
      }
    }
    float vn[4];
    int rn[4], gn[4];
    if (kPrefetch && q + kPass < count) {
      lanes4<kStream>(vals, base + q + kPass, vn);
      lanes4<kStream>(lrow, base + q + kPass, rn);
      lanes4<kStream>(src, base + q + kPass, gn);
    }
    float* row = acc + (q / s) * r_pad;
    int key = -1;
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k =
          static_cast<unsigned>(r[i]) < static_cast<unsigned>(r_pad) ? r[i]
                                                                     : -1;
      if (k != key) {
        if (key >= 0) atomicAdd(&row[key], run);
        key = k;
        run = 0.0f;
      }
      run += v[i] * xs[i];
    }
    const WarpRuns runs = warp_runs(key);
    const float sum = run_sum(runs, run);
    if (key >= 0 && runs.tail) atomicAdd(&row[key], sum);
    if (kPrefetch) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = vn[i];
        r[i] = rn[i];
        g[i] = gn[i];
      }
    } else if (q + kPass < count) {
      lanes4<kStream>(vals, base + q + kPass, v);
      lanes4<kStream>(lrow, base + q + kPass, r);
      lanes4<kStream>(src, base + q + kPass, g);
    }
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(c0) * r_pad;
  for (int i = threadIdx.x; i < items; i += kT) dst[i] = acc[i];
}

// The gather floor: src read and x[src] summed per lane, next pass's src
// loaded before this pass's sums, one float out per thread; kHot gathers
// x[src & 16383] instead, the same loads into 64 KB of x that L1 holds.
template <int kStream, int kX, int kCarve, bool kHot = false>
__global__ void __launch_bounds__(128)
gather_only_kernel(const int* __restrict__ src, const float* __restrict__ x,
                   float* __restrict__ out, int num_chunks, int s, int r_pad,
                   int n, int group) {
  const int c0 = blockIdx.x * group;
  const int chunks = min(group, num_chunks - c0);
  const int count = chunks * s;
  const size_t base = static_cast<size_t>(c0) * s;
  int q = threadIdx.x * 4;
  int g[4];
  if (q < count) lanes4<kStream>(src, base + q, g);
  float sum = 0.0f;
  for (; q < count; q += 512) {
    float xs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xs[i] = load_x<kX>(x, kHot ? g[i] & 16383 : g[i], n, 0);
    }
    if (q + 512 < count) lanes4<kStream>(src, base + q + 512, g);
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += xs[i];
  }
  if (threadIdx.x < chunks * r_pad)
    out[static_cast<size_t>(c0) * r_pad + threadIdx.x] = sum;
}

template <typename K>
cudaError_t carve(K kernel, int carve) {
  if (carve < 0) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carve);
}

template <int kT, int kStream, int kX, bool kPrefetch, bool kGather,
          int kMinBlocks = 1, int kCarve = -1>
int launch_four(const void* vals, const void* lrow, const void* src,
                const void* row0s, const void* x, void* out, int num_chunks,
                int s, int r_pad, int n, int group, cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(group) * r_pad;
  auto* kernel =
      four_kernel<kT, kStream, kX, kPrefetch, kGather, kMinBlocks, kCarve>;
  cudaError_t e = allow_dynamic_smem(kernel, smem);
  if (e == cudaSuccess) e = carve(kernel, kCarve);
  if (e != cudaSuccess) return static_cast<int>(e);
  four_kernel<kT, kStream, kX, kPrefetch, kGather, kMinBlocks, kCarve>
      <<<(num_chunks + group - 1) / group, kT, smem, st>>>(
      static_cast<const float*>(vals), static_cast<const int*>(lrow),
      static_cast<const int*>(src), static_cast<const int*>(row0s),
      static_cast<const float*>(x), static_cast<float*>(out), num_chunks, s,
      r_pad, n, group);
  return static_cast<int>(cudaGetLastError());
}

template <int kStream, int kX, int kCarve, bool kHot = false>
int launch_gather_only(const void* src, const void* x, void* out,
                       int num_chunks, int s, int r_pad, int n, int group,
                       cudaStream_t st) {
  cudaError_t e =
      carve(gather_only_kernel<kStream, kX, kCarve, kHot>, kCarve);
  if (e != cudaSuccess) return static_cast<int>(e);
  gather_only_kernel<kStream, kX, kCarve, kHot>
      <<<(num_chunks + group - 1) / group, 128, 0, st>>>(
      static_cast<const int*>(src), static_cast<const float*>(x),
      static_cast<float*>(out), num_chunks, s, r_pad, n, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// form: the first entry of each FORMS value in the script; group is the
// chunks a block of the candidate forms walks.
extern "C" int probe_k9(int form, const void* vals, const void* lrow,
                        const void* src, const void* row0s, const void* x,
                        void* out, int num_chunks, int s, int r_pad, int n,
                        int group, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FOUR(...)                                                            \
  launch_four<__VA_ARGS__>(vals, lrow, src, row0s, x, out, num_chunks, s,    \
                           r_pad, n, group, st)
  switch (form) {
    case 0:
      return launch_chunk_stream<false>(vals, lrow, src, x, out, num_chunks,
                                        s, r_pad, n, 1, 1, 0, 0, stream);
    case 1: return FOUR(128, 0, 0, false, true);
    case 2: return FOUR(128, 1, 1, false, true);
    case 3: return FOUR(128, 1, 2, false, true);
    case 4: return FOUR(128, 1, 1, true, true);
    case 5: return FOUR(256, 1, 1, true, true);
    case 6: return FOUR(128, 1, 1, true, true, 16);
    case 7: return FOUR(256, 1, 1, true, true, 8);
    case 8: return FOUR(256, 2, 3, true, true, 1, -1);
    case 9: return FOUR(256, 1, 1, true, true, 1, 0);
    case 10: return FOUR(256, 2, 3, true, true, 1, 0);
    case 11: return FOUR(128, 2, 3, true, true, 1, 0);
    case 12: return FOUR(128, 1, 1, true, false);
    case 13:
      return launch_gather_only<1, 1, -1>(src, x, out, num_chunks, s, r_pad,
                                          n, group, st);
    case 14:
      return launch_gather_only<2, 3, 0>(src, x, out, num_chunks, s, r_pad,
                                         n, group, st);
    case 15:
      return launch_gather_only<1, 1, -1, true>(src, x, out, num_chunks, s,
                                                r_pad, n, group, st);
  }
#undef FOUR
  return static_cast<int>(cudaErrorInvalidValue);
}
"""
# name -> (form, chunks a block walks, checked against the plain version)
FORMS = {
    "shipped": (0, 1, True),
    "four": (1, 1, True),
    "four_cs": (2, 1, True),
    "four_cs_el": (3, 1, True),
    **{f"four_multi_t{t}_g{g}": (4 if t == 128 else 5, g, True)
       for t in (128, 256) for g in (2, 4, 8)},
    **{f"four_multi_t{t}_g{g}_r32": (6 if t == 128 else 7, g, True)
       for t in (128, 256) for g in (4, 8)},
    "four_multi_t256_g2_l1": (8, 2, True),
    "four_multi_t256_g2_c0": (9, 2, True),
    "four_multi_t256_g2_l1_c0": (10, 2, True),
    "four_multi_t128_g2_l1_c0": (11, 2, True),
    "stream_only": (12, 8, False),
    "gather_only": (13, 8, False),
    "gather_only_l1_c0": (14, 8, False),
    "gather_only_hot": (15, 8, False),
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published


def registers(lib):
    """Registers per thread of each kernel in the library, by demangled
    name (``cuobjdump -res-usage``)."""
    from repro_torch.kernels import _build
    bin_dir = os.path.dirname(_build.find_nvcc())
    text = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-res-usage",
                           lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for name, reg in re.findall(r"Function (\S+):\s*REG:(\d+)", text):
        try:
            name = subprocess.run([os.path.join(bin_dir, "cu++filt"), name],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            pass
        out[name] = int(reg)
    return out


def build_probe():
    """Compile SOURCE beside the kernels' builds; returns the library and
    its path."""
    from repro_torch.kernels import _build
    os.makedirs(_build.build_dir(), exist_ok=True)
    src = os.path.join(_build.build_dir(), "k9_body_probe.cu")
    lib = src[:-3] + ".so"
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", lib, src], check=True)
    handle = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.probe_k9.argtypes = [I] + [P] * 6 + [I] * 5 + [P]
    return handle, lib


def event_ms(fn, reps=20):
    """Milliseconds per call after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2_097_152)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as sm
    from repro_torch import device as device_mod
    from repro_torch.core import csrc
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz

    lib, lib_path = build_probe()
    n = args.n
    x = torch.from_numpy(sm.dyadic_vector(np.random.default_rng(args.seed),
                                          (n,))).cuda()
    M = csrc.from_assembly(n, *sm.powerlaw_arrays(n, args.seed + 300,
                                                  dyadic=True))
    pack = nz.pack_nnzsplit(M, ks=8).to("cuda")
    del M
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((pack.num_chunks, pack.r_pad), device="cuda")

    def launch(form, group):
        def run():
            err = lib.probe_k9(
                form, pack.vals.data_ptr(), pack.lrow.data_ptr(),
                pack.src.data_ptr(), pack.chunk_row0.data_ptr(),
                x.data_ptr(), out.data_ptr(), pack.num_chunks, pack.s,
                pack.r_pad, n, group, stream)
            if err:
                raise RuntimeError(f"probe form {form}: cudaError {err}")
        return run

    want = nz.nnzsplit_partials_stream_plain(pack, x)
    runs = {}
    for name, (form, group, checked) in FORMS.items():
        run = launch(form, group)
        run()
        torch.cuda.synchronize()
        if checked and not torch.equal(out, want):
            err = float((out - want).abs().max())
            print(f"K9 {name} differs from its plain version (max abs err "
                  f"{err})", file=sys.stderr)
            return 1
        runs[name] = run
    del want
    times = {name: [] for name in runs}
    for turn in range(4):
        for name in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            times[name].append(event_ms(runs[name]))
    entries = pack.num_chunks * pack.s
    kernel_bytes = (sum(a.numel() * a.element_size()
                        for a in (pack.vals, pack.lrow, pack.src))
                    + (pack.num_chunks * pack.r_pad + n) * 4)
    ms = {name: float(np.median(times[name])) for name in runs}
    print(json.dumps({
        "n": n, "chunks": pack.num_chunks, "s": pack.s, "r_pad": pack.r_pad,
        "entries": entries, "kernel_bytes": kernel_bytes,
        "bound_ms": kernel_bytes / HBM_BYTES_PER_S * 1e3,
        "gather_sector_bytes": 32 * entries,
        "ms": ms,
        "tb_per_s": {name: kernel_bytes / (t * 1e-3) / 1e12
                     for name, t in ms.items()},
        "runs": times, "registers": registers(lib_path),
        "card": device_mod.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
