#!/usr/bin/env python3
"""K13's launch structure and loads against the alternatives, at the full
assembly mesh.

    python3 tools/k13_launch_probe.py [--cubes 64 32 32] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds the greedy-colored schedule of
``chip_smoke.py``'s assembly mesh (Kuhn tetrahedra, three DOFs per node),
then times on the card with CUDA events, in turns, each form into a zeroed
vector:

  k13_ms        K13 as it ships: one ordinary launch per color on one
                stream, one entry per thread, cache-streaming loads
                (``add_entry`` of csrc/assembly_colored_stream.cu);
  coop_ms       the same entries in ONE cooperative launch, threads
                striding over each color, a grid barrier between colors;
  grouped_ms    one launch per color, four entries per thread (entries
                lane + 32u of a warp's 128, all loads before the adds);
  no_hint_ms    K13's launches with plain loads instead of ``__ldcs``;
  zeros_ms      the zeroed vector alone (``torch.zeros``);
  barrier_us    one grid barrier: the cooperative form on C all-padding
                colors of width 128 less on one such color, over C - 1;
  launch_us     one more color launch: K13 on those packs, the same way.

The two empty-pack timings queue their launches behind ``torch.cuda._sleep``
so that the host's call rate does not set them.  Every form is held against
K13 bit for bit first (a greedy color adds to each target once).  Prints
one JSON line with the card's name and power limit.
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

SOURCE = r"""
#include <cooperative_groups.h>

#include "assembly_colored_stream.cu"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(kThreads)
coop_kernel(const int* __restrict__ slots, const int* __restrict__ tgts,
            const float* __restrict__ kvals, float* out, int num_colors,
            int lmax, int num_contribs, int size) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int c = 0; c < num_colors; ++c) {
    const size_t row = static_cast<size_t>(c) * lmax;
    for (long long i = first; i < lmax; i += stride) {
      add_entry(slots + row, tgts + row, kvals, out, i, num_contribs, size);
    }
    if (c + 1 < num_colors) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads)
grouped_kernel(const int* __restrict__ slots, const int* __restrict__ tgts,
               const float* __restrict__ kvals, float* out, int lmax,
               int num_contribs, int size) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32 *
      128 + threadIdx.x % 32;
  int s[4], t[4];
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const long long i = base + 32 * u;
    s[u] = i < lmax ? __ldcs(slots + i) : -1;
    t[u] = i < lmax ? __ldcs(tgts + i) : -1;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const bool ok = in_range(s[u], num_contribs) && in_range(t[u], size);
    v[u] = ok ? __ldcs(kvals + s[u]) : 0.0f;
    if (!ok) t[u] = -1;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (t[u] >= 0) atomicAdd(out + t[u], v[u]);
  }
}

__global__ void __launch_bounds__(kThreads)
no_hint_kernel(const int* __restrict__ slots, const int* __restrict__ tgts,
               const float* __restrict__ kvals, float* out, int lmax,
               int num_contribs, int size) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= lmax) return;
  const int s = slots[i], t = tgts[i];
  if (in_range(s, num_contribs) && in_range(t, size)) {
    atomicAdd(out + t, kvals[s]);
  }
}

template <typename K>
int per_color(K kernel, int per_block, const void* slots, const void* tgts,
              const void* kvals, void* out, int num_colors, int lmax,
              int num_contribs, int size, void* stream) {
  const int blocks = (lmax + per_block - 1) / per_block;
  for (int c = 0; c < num_colors; ++c) {
    const size_t row = static_cast<size_t>(c) * lmax;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(slots) + row,
        static_cast<const int*>(tgts) + row,
        static_cast<const float*>(kvals), static_cast<float*>(out), lmax,
        num_contribs, size);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_coop(const void* slots, const void* tgts,
                          const void* kvals, void* out, int num_colors,
                          int lmax, int num_contribs, int size,
                          void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, coop_kernel,
                                                kThreads, 0);
  void* args[] = {&slots, &tgts, &kvals, &out, &num_colors, &lmax,
                  &num_contribs, &size};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(coop_kernel), dim3(per_sm * sms),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" int probe_grouped(const void* slots, const void* tgts,
                             const void* kvals, void* out, int num_colors,
                             int lmax, int num_contribs, int size,
                             void* stream) {
  return per_color(grouped_kernel, 4 * kThreads, slots, tgts, kvals, out,
                   num_colors, lmax, num_contribs, size, stream);
}

extern "C" int probe_no_hint(const void* slots, const void* tgts,
                             const void* kvals, void* out, int num_colors,
                             int lmax, int num_contribs, int size,
                             void* stream) {
  return per_color(no_hint_kernel, kThreads, slots, tgts, kvals, out,
                   num_colors, lmax, num_contribs, size, stream);
}
"""
FORMS = ("coop", "grouped", "no_hint")


def build_probe():
    """Compile SOURCE beside the kernels' builds; returns form -> function."""
    from repro_torch.kernels import _build
    os.makedirs(_build.build_dir(), exist_ok=True)
    src = os.path.join(_build.build_dir(), "k13_launch_probe.cu")
    lib = src[:-3] + ".so"
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", lib, src], check=True)
    fns = {}
    handle = ctypes.CDLL(lib)
    for form in FORMS:
        fn = getattr(handle, "probe_" + form)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[form] = fn
    return fns


def event_ms(fn, reps=20, sleep_cycles=0):
    """Milliseconds per call after one warm-up; with ``sleep_cycles`` the
    calls queue behind a spinning kernel, so the card, not the host's call
    rate, sets the time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cubes", type=int, nargs=3, default=(64, 32, 32))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch import device as device_mod
    from repro_torch.assembly import mesh as amesh
    from repro_torch.assembly import scatter as asc
    from repro_torch.kernels import assembly_scatter as ak

    mesh = amesh.grid_tet(*args.cubes)
    sched = asc.build_assembly_schedule(mesh, 3)
    packs = sched.bind("cuda").colored
    if packs.repeats or packs.slots.dtype != torch.int32 or (
            packs.tgts.dtype != torch.int32):
        print("the probe takes greedy packs with int32 streams",
              file=sys.stderr)
        return 1
    k = torch.randn(sched.num_contribs, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(args.seed))
    size, G, C = sched.size, sched.num_contribs, packs.num_colors
    fns = build_probe()

    def form(fn, p):
        def run():
            out = torch.zeros(size, device="cuda")
            err = fn(p.slots.data_ptr(), p.tgts.data_ptr(), k.data_ptr(),
                     out.data_ptr(), p.num_colors, p.lmax, G, size,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe form: cudaError {err}")
            return out
        return run

    runs = {"k13_ms": lambda: ak.colored_scatter_stream_cuda(packs, k),
            **{f + "_ms": form(fn, packs) for f, fn in fns.items()},
            "zeros_ms": lambda: torch.zeros(size, device="cuda")}
    want = runs["k13_ms"]()
    for name in FORMS:
        if not torch.equal(runs[name + "_ms"](), want):
            print(f"{name} differs from K13", file=sys.stderr)
            return 1
    times = {name: [] for name in runs}
    for turn in range(4):
        for name in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            times[name].append(event_ms(runs[name]))

    def empty(colors):
        return ak.pack_colored_streams(np.full((colors, 128), G, np.int32),
                                       np.full((colors, 128), size, np.int32),
                                       G, size).to("cuda")
    def k13_on(p):
        return lambda: ak.colored_scatter_stream_cuda(p, k)
    empties = {"coop": (form(fns["coop"], empty(C)),
                        form(fns["coop"], empty(1))),
               "k13": (k13_on(empty(C)), k13_on(empty(1)))}
    per_extra = {}
    for name, (many, one) in empties.items():
        t_many = [event_ms(many, 50, 10 ** 8) for _ in range(3)]
        t_one = [event_ms(one, 50, 10 ** 8) for _ in range(3)]
        per_extra[name] = 1e3 * (float(np.median(t_many))
                                 - float(np.median(t_one))) / (C - 1)
        times[f"empty_{name}_{C}_ms"] = t_many
        times[f"empty_{name}_1_ms"] = t_one
    print(json.dumps({
        "mesh": "tet%dx%dx%d" % tuple(args.cubes), "colors": C,
        "lmax": packs.lmax, "size": size, "contributions": G,
        **{name: float(np.median(times[name])) for name in runs},
        "barrier_us": per_extra["coop"], "launch_us": per_extra["k13"],
        "runs": times, "card": device_mod.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
