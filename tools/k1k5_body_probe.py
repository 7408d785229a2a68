#!/usr/bin/env python3
"""K1/K5's stream SpMV body against its earlier forms, and K5's heavy and
light tiles apart, at the main paths' shapes.

    python3 tools/k1k5_body_probe.py [--n 2097152] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds ``chip_smoke.py``'s ``fem_sym``
(K1: band of 24 at fill 0.6, rectangular pack) and ``skew_sym`` (K5: a
512-wide band on the first 6 % of rows, 3 on the rest, flat pack)
matrices with dyadic values, holds every form against the plain version
exactly, then times each with CUDA events, in turns:

  shipped     K1/K5 as they ship (csrc/window_kernels.cuh): four slots per
              lane in one vector load, each lane's slots summed by row,
              the lanes' runs summed across the warp, one add per run; the
              column half in a swizzled slot order, one bank per lane;
  four_slot   the same in slot order: on a long row's consecutive columns
              four lanes add into one bank at once;
  one_slot    one slot per lane, the warp's runs of equal rows summed by
              shuffles before one add per run (no vector loads);
  per_slot    one slot per lane, one shared atomicAdd per slot on the row
              side and one on the column side (the body before run sums).

For K5 each form is timed three ways: all tiles, the tiles of more than
one k-step alone (the wide band's: the first blocks launched) and the
one-step tiles alone, through a ``step_start`` cut to each set.  A cut
launch reads another part of x for each tile and overwrites the windows:
it is timed, not checked.  Prints one JSON line with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SOURCE = r"""
#include "window_kernels.cuh"

namespace {

// The x window and the zeroed accumulator of tile b.
__device__ __forceinline__ void open_window(float* xw, float* acc,
                                            const float* x, int b, int tm,
                                            int w_pad, int n) {
  for (int w = threadIdx.x; w < w_pad; w += kThreads) {
    long long g = window_row(b, tm, w_pad, w, n);
    xw[w] = g >= 0 ? x[g] : 0.0f;
    acc[w] = 0.0f;
  }
  __syncthreads();
}

// The diagonal after the adds, then the window out.
__device__ __forceinline__ void close_window(float* xw, float* acc,
                                             const float* ad, float* out,
                                             int b, int tm, int w_pad) {
  __syncthreads();
  const int d0 = w_pad - tm;
  for (int t = threadIdx.x; t < tm; t += kThreads)
    acc[d0 + t] += ad[static_cast<size_t>(b) * tm + t] * xw[d0 + t];
  __syncthreads();
  float* dst = out + static_cast<size_t>(b) * w_pad;
  for (int w = threadIdx.x; w < w_pad; w += kThreads) dst[w] = acc[w];
}

template <typename Tiles, bool kRuns>
__global__ void __launch_bounds__(kThreads)
one_slot_kernel(const float* __restrict__ vals_l,
                const float* __restrict__ vals_u,
                const int* __restrict__ col, const int* __restrict__ row,
                const float* __restrict__ ad, const float* __restrict__ x,
                float* __restrict__ out, Tiles tiles, int tm, int w_pad,
                int n, int num_sym) {
  extern __shared__ float smem[];
  float* xw = smem;
  float* acc = smem + w_pad;
  const int b = blockIdx.x;
  open_window(xw, acc, x, b, tm, w_pad, n);
  const TileSlots ts = tiles(b);
  const int lane = threadIdx.x & 31;
  for (int p0 = threadIdx.x - lane; p0 < ts.count; p0 += kThreads) {
    const size_t p = ts.base + p0 + lane;
    const int c = col[p];
    const int r = row[p];
    const bool in_win =
        static_cast<unsigned>(r) < static_cast<unsigned>(w_pad);
    const float vl = vals_l[p];
    const float prod = vl * xw[min(max(c, 0), w_pad - 1)];
    if (kRuns) {
      const WarpRuns runs = warp_runs(in_win ? r : -1);
      const float sum = run_sum(runs, prod);
      if (in_win && runs.tail) atomicAdd(&acc[r], sum);
    } else if (in_win) {
      atomicAdd(&acc[r], prod);
    }
    if (in_win && static_cast<unsigned>(c) < static_cast<unsigned>(w_pad))
      atomicAdd(&acc[c], (num_sym ? vl : vals_u[p]) * xw[r]);
  }
  close_window(xw, acc, ad, out, b, tm, w_pad);
}

template <typename Tiles>
__global__ void __launch_bounds__(kThreads)
four_slot_kernel(const float* __restrict__ vals_l,
                 const float* __restrict__ vals_u,
                 const int* __restrict__ col, const int* __restrict__ row,
                 const float* __restrict__ ad, const float* __restrict__ x,
                 float* __restrict__ out, Tiles tiles, int tm, int w_pad,
                 int n, int num_sym) {
  extern __shared__ float smem[];
  float* xw = smem;
  float* acc = smem + w_pad;
  const int b = blockIdx.x;
  open_window(xw, acc, x, b, tm, w_pad, n);
  const TileSlots ts = tiles(b);
  for (int q = threadIdx.x * 4; q < ts.count; q += kThreads * 4) {
    const size_t at = ts.base + q;
    int cs[4], rs[4];
    float ls[4], us[4];
    load4(col, at, cs);
    load4(row, at, rs);
    load4(vals_l, at, ls);
    if (!num_sym) load4(vals_u, at, us);
    int key = -1;
    float run = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rs[i];
      const int c = cs[i];
      const bool in_win =
          static_cast<unsigned>(r) < static_cast<unsigned>(w_pad);
      const int k = in_win ? r : -1;
      if (k != key) {
        if (key >= 0) atomicAdd(&acc[key], run);
        key = k;
        run = 0.0f;
      }
      run += ls[i] * xw[min(max(c, 0), w_pad - 1)];
      if (in_win && static_cast<unsigned>(c) < static_cast<unsigned>(w_pad))
        atomicAdd(&acc[c], (num_sym ? ls[i] : us[i]) * xw[r]);
    }
    const WarpRuns runs = warp_runs(key);
    const float sum = run_sum(runs, run);
    if (key >= 0 && runs.tail) atomicAdd(&acc[key], sum);
  }
  close_window(xw, acc, ad, out, b, tm, w_pad);
}

template <typename Tiles>
int launch(int form, const void* vals_l, const void* vals_u,
           const void* col, const void* row, const void* ad, const void* x,
           void* out, Tiles tiles, int nt, int tm, int w_pad, int n,
           int num_sym, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(w_pad) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS                                                               \
  static_cast<const float*>(vals_l), static_cast<const float*>(vals_u),    \
      static_cast<const int*>(col), static_cast<const int*>(row),          \
      static_cast<const float*>(ad), static_cast<const float*>(x),         \
      static_cast<float*>(out), tiles, tm, w_pad, n, num_sym
  if (form == 0)
    spmv_stream_kernel<float, int, Tiles><<<nt, kThreads, smem, st>>>(ARGS);
  if (form == 1) four_slot_kernel<Tiles><<<nt, kThreads, smem, st>>>(ARGS);
  if (form == 2)
    one_slot_kernel<Tiles, true><<<nt, kThreads, smem, st>>>(ARGS);
  if (form == 3)
    one_slot_kernel<Tiles, false><<<nt, kThreads, smem, st>>>(ARGS);
#undef ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_rect(int form, const void* vals_l, const void* vals_u,
                          const void* col, const void* row, const void* ad,
                          const void* x, void* out, int nt, int s, int tm,
                          int w_pad, int n, int num_sym, void* stream) {
  return launch(form, vals_l, vals_u, col, row, ad, x, out, RectTiles{s}, nt,
                tm, w_pad, n, num_sym, stream);
}

extern "C" int probe_flat(int form, const void* vals_l, const void* vals_u,
                          const void* col, const void* row, const void* ad,
                          const void* step_start, const void* x, void* out,
                          int nt, int step, int tm, int w_pad, int n,
                          int num_sym, void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch(form, vals_l, vals_u, col, row, ad, x, out, tiles, nt, tm,
                w_pad, n, num_sym, stream);
}
"""
FORMS = ("shipped", "four_slot", "one_slot", "per_slot")


def build_probe():
    """Compile SOURCE beside the kernels' builds; returns the library."""
    from repro_torch.kernels import _build
    os.makedirs(_build.build_dir(), exist_ok=True)
    src = os.path.join(_build.build_dir(), "k1k5_body_probe.cu")
    lib = src[:-3] + ".so"
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", lib, src], check=True)
    handle = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.probe_rect.argtypes = [I] + [P] * 7 + [I] * 6 + [P]
    handle.probe_flat.argtypes = [I] + [P] * 8 + [I] * 6 + [P]
    return handle


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
    from repro_torch.core import blockell, csrc
    from repro_torch.kernels import csrc_spmv as mv
    from repro_torch.kernels import csrc_spmv_flat as fl

    lib = build_probe()
    n = args.n
    x = torch.from_numpy(sm.dyadic_vector(np.random.default_rng(args.seed),
                                          (n,))).cuda()
    stream = torch.cuda.current_stream().cuda_stream

    def streams(pack):
        return (pack.vals_l.data_ptr(), pack.vals_u.data_ptr(),
                pack.col_local.data_ptr(), pack.row_in_win.data_ptr(),
                pack.ad.data_ptr())

    def rect(pack, form, out):
        def run():
            err = lib.probe_rect(form, *streams(pack), x.data_ptr(),
                                 out.data_ptr(), pack.nt, pack.s, pack.tm,
                                 pack.w_pad, n, int(pack.num_symmetric),
                                 stream)
            if err:
                raise RuntimeError(f"probe form {form}: cudaError {err}")
        return run

    def flat(pack, form, out, t0=0, nt=None):
        def run():
            err = lib.probe_flat(
                form, *streams(pack), pack.step_start.data_ptr() + 4 * t0,
                x.data_ptr(), out.data_ptr(),
                pack.nt if nt is None else nt, pack.step, pack.tm,
                pack.w_pad, n, int(pack.num_symmetric), stream)
            if err:
                raise RuntimeError(f"probe form {form}: cudaError {err}")
        return run

    M = csrc.from_assembly(n, *sm.band_arrays(
        n, sm.HALF_BAND, sm.FILL, args.seed + 101, True, dyadic=True))
    rpack = blockell.pack(M).to("cuda")
    M = csrc.from_assembly(n, *sm.skew_arrays(
        n, sm.SKEW_WIDE, sm.SKEW_NARROW, args.seed + 201, True,
        dyadic=True))
    fpack = fl.pack_flat(M).to("cuda")
    del M
    steps = torch.diff(fpack.step_start.cpu())
    heavy = int(torch.nonzero(steps == 1)[0])     # tiles before the first
    if not bool((steps[:heavy] > 1).all()):       # one-step tile
        print("the wide band's tiles are not the first ones",
              file=sys.stderr)
        return 1

    runs = {}
    for form, name in enumerate(FORMS):
        out = torch.empty((rpack.nt, rpack.w_pad), device="cuda")
        rect(rpack, form, out)()
        if not torch.equal(out, mv.spmv_windows_stream_plain(rpack, x)):
            print(f"K1 {name} differs from its plain version",
                  file=sys.stderr)
            return 1
        runs[f"k1_{name}_ms"] = rect(rpack, form, out)
        out = torch.empty((fpack.nt, fpack.w_pad), device="cuda")
        flat(fpack, form, out)()
        if not torch.equal(out, fl.flat_windows_stream_plain(fpack, x)):
            print(f"K5 {name} differs from its plain version",
                  file=sys.stderr)
            return 1
        runs[f"k5_{name}_ms"] = flat(fpack, form, out)
        runs[f"k5_{name}_heavy_ms"] = flat(fpack, form, out, 0, heavy)
        runs[f"k5_{name}_light_ms"] = flat(fpack, form, out, heavy,
                                           fpack.nt - heavy)
    times = {name: [] for name in runs}
    for turn in range(4):
        for name in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            times[name].append(event_ms(runs[name]))
    heavy_steps = int(fpack.step_start[heavy])
    print(json.dumps({
        "n": n, "k1_slots": rpack.nt * rpack.s,
        "k5_tiles": fpack.nt, "k5_heavy_tiles": heavy,
        "k5_heavy_steps": heavy_steps,
        "k5_light_steps": fpack.total_steps - heavy_steps,
        "k5_step_bytes": fpack.step * 12,
        **{name: float(np.median(times[name])) for name in runs},
        "runs": times, "card": device_mod.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
