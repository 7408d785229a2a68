#!/usr/bin/env python3
"""K2/K6's stream SpMM body and K10's staged gather against their earlier
forms at the main paths' shapes, K6's heavy and light tiles apart, and the
shared-memory atomics the bodies compile to.

    python3 tools/k6k10_body_probe.py [--n 2097152] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds ``chip_smoke.py``'s ``fem_sym``
(K2: band of 24 at fill 0.6, rectangular pack), ``skew_sym`` (K6: a
512-wide band on the first 6 % of rows, 3 on the rest, flat pack) and
``pl_sym`` (K10: power-law graph, nnz-split pack) matrices with dyadic
values, holds every form against the plain version exactly on dyadic X at
B = 8 and 11, then times each with CUDA events, medians of four turns:

  K2/K6  shipped    csrc/window_kernels.cuh: four slots per lane read once
                    per pass, the warp's row runs found once per pass, per
                    column the row half summed by run before one shared add
                    per run piece, the column half one add per slot;
         items      the body before it: (slot, column) work items with the
                    column fastest, each reloading its slot's streams and
                    making two shared atomicAdds;
  K10    shipped    csrc/chunk_kernels.cuh with the warp's 32 X rows copied
                    into shared memory with the column fastest first;
         direct     the same body gathering X one column at a time (K9's
                    gather, the body before it);
         four       four entries per lane in one vector load of each
                    stream, summed by row in the lane before the warp's
                    scan, 128 X rows staged per warp.

K6's forms are also timed on the tiles of more than one k-step alone (the
wide band's: the first blocks launched) and on the one-step tiles alone,
through a ``step_start`` cut to each set: such a launch reads another part
of X for each tile and overwrites the windows, so it is timed, not checked.

The SASS of the probe's library (``cuobjdump -sass``) is read for the
shared-memory atomics of each form: the opcodes of every ``ATOMS``
instruction and whether a shared ``atomicAdd(float*)`` is a native add or a
compare-and-swap loop.  Prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import collections
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
#include "window_kernels.cuh"
#include "chunk_kernels.cuh"

namespace {

// K2/K6 before the run sums: (slot, column) items, column fastest.
template <typename Tiles>
__global__ void __launch_bounds__(kThreads)
item_spmm_kernel(const float* __restrict__ vals_l,
                 const float* __restrict__ vals_u,
                 const int* __restrict__ col, const int* __restrict__ row,
                 const float* __restrict__ ad, const float* __restrict__ x,
                 float* __restrict__ out, Tiles tiles, int tm, int w_pad,
                 int n, int nrhs, int bt, int num_sym) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int j0 = blockIdx.y * bt;
  const int cols = min(bt, nrhs - j0);
  const int tid = threadIdx.x;
  float* xw = smem;
  float* acc = smem + static_cast<size_t>(w_pad) * bt;
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
    const int c = col[base + p];
    const int r = row[base + p];
    if (static_cast<unsigned>(r) >= static_cast<unsigned>(w_pad)) continue;
    const float vl = vals_l[base + p];
    const int cg = min(max(c, 0), w_pad - 1);
    atomicAdd(&acc[r * cols + j], vl * xw[cg * cols + j]);
    if (static_cast<unsigned>(c) < static_cast<unsigned>(w_pad)) {
      const float vu = num_sym ? vl : vals_u[base + p];
      atomicAdd(&acc[c * cols + j], vu * xw[r * cols + j]);
    }
  }
  __syncthreads();
  const int d0 = w_pad - tm;
  for (int q = tid; q < tm * cols; q += kThreads) {
    const int t = q / cols;
    const int j = q - t * cols;
    const int at = (d0 + t) * cols + j;
    acc[at] += ad[static_cast<size_t>(b) * tm + t] * xw[at];
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
int launch_items(const void* vals_l, const void* vals_u, const void* col,
                 const void* row, const void* ad, const void* x, void* out,
                 Tiles tiles, int nt, int tm, int w_pad, int n, int nrhs,
                 int bt, int num_sym, cudaStream_t st) {
  const size_t smem = 2 * static_cast<size_t>(w_pad) * bt * sizeof(float);
  cudaError_t e = allow_dynamic_smem(item_spmm_kernel<Tiles>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  item_spmm_kernel<Tiles><<<dim3(nt, (nrhs + bt - 1) / bt), kThreads, smem,
                            st>>>(
      static_cast<const float*>(vals_l), static_cast<const float*>(vals_u),
      static_cast<const int*>(col), static_cast<const int*>(row),
      static_cast<const float*>(ad), static_cast<const float*>(x),
      static_cast<float*>(out), tiles, tm, w_pad, n, nrhs, bt, num_sym);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tiles>
int launch_window(int form, const void* vals_l, const void* vals_u,
                  const void* col, const void* row, const void* ad,
                  const void* x, void* out, Tiles tiles, int nt, int tm,
                  int w_pad, int n, int nrhs, int bt, int num_sym,
                  void* stream) {
  if (form == 0)
    return launch_spmm_stream(vals_l, vals_u, col, row, ad, x, out, tiles,
                              nt, tm, w_pad, n, nrhs, bt, num_sym, 0, 0,
                              stream);
  return launch_items(vals_l, vals_u, col, row, ad, x, out, tiles, nt, tm,
                      w_pad, n, nrhs, bt, num_sym,
                      static_cast<cudaStream_t>(stream));
}

// K10 with four entries per lane: one vector load of each stream, the
// lane's entries summed by row before the warp's scan, the warp's 128 X
// rows staged with the column fastest.
constexpr int kFourThreads = 128;

__global__ void __launch_bounds__(kFourThreads)
four_entry_kernel(const float* __restrict__ vals, const int* __restrict__ lrow,
                  const int* __restrict__ src, const float* __restrict__ x,
                  float* __restrict__ out, int s, int r_pad, int n, int nrhs,
                  int bt) {
  extern __shared__ float smem[];
  float* acc = smem;
  const int c = blockIdx.x;
  const int j0 = blockIdx.y * bt;
  const int cols = min(bt, nrhs - j0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ld = cols | 1;
  float* buf = smem + static_cast<size_t>(r_pad) * bt +
               static_cast<size_t>(tid >> 5) * 128 * (bt | 1);
  int* sidx = reinterpret_cast<int*>(smem + static_cast<size_t>(r_pad) * bt +
                                     4 * 128 * static_cast<size_t>(bt | 1)) +
              (tid >> 5) * 128;           // the warp's 128 src indices
  for (int q = tid; q < r_pad * cols; q += kFourThreads) acc[q] = 0.0f;
  __syncthreads();
  const size_t base = static_cast<size_t>(c) * s;
  for (int q = tid * 4; q < s; q += kFourThreads * 4) {
    int ks[4], gs[4];
    float vs[4];
    load4(lrow, base + q, ks);
    load4(src, base + q, gs);
    load4(vals, base + q, vs);
    const int key = ks[3];
    const WarpRuns runs = warp_runs(key);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) sidx[lane * 4 + i] = gs[i];
    __syncwarp();
    int e = lane / cols, j = lane - (lane / cols) * cols;
    for (int t = 0; t < 4 * cols; ++t) {   // 128 * cols pairs
      buf[e * ld + j] = gather_x(x, sidx[e], n, nrhs, j0 + j);
      e += 32 / cols;
      j += 32 % cols;
      if (j >= cols) {
        j -= cols;
        ++e;
      }
    }
    __syncwarp();
    for (int j = 0; j < cols; ++j) {
      int k_run = -1;
      float run = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ks[i] != k_run) {
          if (static_cast<unsigned>(k_run) < static_cast<unsigned>(r_pad))
            atomicAdd(&acc[k_run * cols + j], run);
          k_run = ks[i];
          run = 0.0f;
        }
        run += vs[i] * buf[(lane * 4 + i) * ld + j];
      }
      const float sum = run_sum(runs, run);
      if (runs.tail && static_cast<unsigned>(key) < static_cast<unsigned>(r_pad))
        atomicAdd(&acc[key * cols + j], sum);
    }
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(c) * r_pad * nrhs;
  for (int q = tid; q < r_pad * cols; q += kFourThreads) {
    const int r = q / cols;
    const int j = q - r * cols;
    dst[static_cast<size_t>(r) * nrhs + j0 + j] = acc[q];
  }
}

}  // namespace

extern "C" int probe_rect(int form, const void* vals_l, const void* vals_u,
                          const void* col, const void* row, const void* ad,
                          const void* x, void* out, int nt, int s, int tm,
                          int w_pad, int n, int nrhs, int bt, int num_sym,
                          void* stream) {
  return launch_window(form, vals_l, vals_u, col, row, ad, x, out,
                       RectTiles{s}, nt, tm, w_pad, n, nrhs, bt, num_sym,
                       stream);
}

extern "C" int probe_flat(int form, const void* vals_l, const void* vals_u,
                          const void* col, const void* row, const void* ad,
                          const void* step_start, const void* x, void* out,
                          int nt, int step, int tm, int w_pad, int n,
                          int nrhs, int bt, int num_sym, void* stream) {
  const FlatTiles tiles{static_cast<const int*>(step_start), step};
  return launch_window(form, vals_l, vals_u, col, row, ad, x, out, tiles,
                       nt, tm, w_pad, n, nrhs, bt, num_sym, stream);
}

extern "C" int probe_chunk(int form, const void* vals, const void* lrow,
                           const void* src, const void* x, void* out,
                           int num_chunks, int s, int r_pad, int n, int nrhs,
                           int bt, void* stream) {
  if (form == 0)
    return launch_chunk_stream<true>(vals, lrow, src, x, out, num_chunks, s,
                                     r_pad, n, nrhs, bt, 0, 0, stream);
  if (form == 1)
    return launch_chunk_stream<false>(vals, lrow, src, x, out, num_chunks, s,
                                      r_pad, n, nrhs, bt, 0, 0, stream);
  const size_t smem = sizeof(float) * (static_cast<size_t>(r_pad) * bt +
                                       4 * 128 * static_cast<size_t>(bt | 1) +
                                       4 * 128);
  cudaError_t e = allow_dynamic_smem(four_entry_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  four_entry_kernel<<<dim3(num_chunks, (nrhs + bt - 1) / bt), kFourThreads,
                      smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(lrow),
      static_cast<const int*>(src), static_cast<const float*>(x),
      static_cast<float*>(out), s, r_pad, n, nrhs, bt);
  return static_cast<int>(cudaGetLastError());
}
"""
WINDOW_FORMS = ("shipped", "items")
CHUNK_FORMS = ("shipped", "direct", "four")
WIDTHS = (8, 11)


def build_probe():
    """Compile SOURCE beside the kernels' builds; returns the library and
    its path."""
    from repro_torch.kernels import _build
    os.makedirs(_build.build_dir(), exist_ok=True)
    src = os.path.join(_build.build_dir(), "k6k10_body_probe.cu")
    lib = src[:-3] + ".so"
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", lib, src], check=True)
    handle = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    handle.probe_rect.argtypes = [I] + [P] * 7 + [I] * 8 + [P]
    handle.probe_flat.argtypes = [I] + [P] * 8 + [I] * 8 + [P]
    handle.probe_chunk.argtypes = [I] + [P] * 5 + [I] * 6 + [P]
    return handle, lib


def sass_atomics(lib):
    """Per kernel of the library (demangled where ``cu++filt`` runs): the
    count of each atomic opcode (``ATOMS.*`` shared, ``ATOM``/``RED``
    global), how many shared atomics sit in a loop of at most 12
    instructions closed by a backward branch (the compare-and-swap form of
    an ``atomicAdd(float*)``), and the opcodes of the first such loop."""
    from repro_torch.kernels import _build
    bin_dir = os.path.dirname(_build.find_nvcc())
    text = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    report = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        try:
            name = subprocess.run(
                [os.path.join(bin_dir, "cu++filt"), name],
                capture_output=True, text=True, check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            pass
        code = []        # (address, opcode, operands) in order
        labels = {}      # branch label -> address of its instruction
        pending = []
        for line in part.split("\n"):
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.search(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]+)([^;]*);", line)
            if m:
                addr = int(m.group(1), 16)
                labels.update({lab: addr for lab in pending})
                pending = []
                code.append((addr, m.group(2), m.group(3)))
        ops = collections.Counter(op for _, op, _ in code
                                  if op.startswith(("ATOMS", "ATOM", "RED")))
        if not ops:
            continue
        loops = []       # (first index, branch index) of short back loops
        for k, (addr, op, rest) in enumerate(code):
            t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", rest)
            if not op.startswith("BRA") or not t:
                continue
            target = labels.get(t.group(1)) if t.group(1) else int(
                t.group(2), 16)
            first = next((i for i, c in enumerate(code) if c[0] == target),
                         None)
            if first is not None and first <= k and k - first < 12:
                loops.append((first, k))
        in_loops = sum(
            1 for i, (_, op, _) in enumerate(code) if op.startswith("ATOMS")
            and any(a <= i <= b for a, b in loops))
        first_loop = next(([code[i][1] for i in range(a, b + 1)]
                           for a, b in loops
                           if any(code[i][1].startswith("ATOMS")
                                  for i in range(a, b + 1))), [])
        report[name] = {"atomics": dict(ops), "atoms_in_cas_loops": in_loops,
                        "cas_loop": first_loop}
    return report


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
    from repro_torch.kernels import csrc_spmm as mm
    from repro_torch.kernels import csrc_spmv_flat as fl
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz

    lib, lib_path = build_probe()
    n = args.n
    rng = np.random.default_rng(args.seed)
    X = {b: torch.from_numpy(sm.dyadic_vector(rng, (n, b))).cuda()
         for b in WIDTHS}
    stream = torch.cuda.current_stream().cuda_stream

    def streams(pack):
        return (pack.vals_l.data_ptr(), pack.vals_u.data_ptr(),
                pack.col_local.data_ptr(), pack.row_in_win.data_ptr(),
                pack.ad.data_ptr())

    def checked(err, what):
        if err:
            raise RuntimeError(f"probe {what}: cudaError {err}")

    def rect(pack, form, b, out):
        def run():
            checked(lib.probe_rect(
                form, *streams(pack), X[b].data_ptr(), out.data_ptr(),
                pack.nt, pack.s, pack.tm, pack.w_pad, n, b,
                mm.column_tile(pack.w_pad, b, 2), int(pack.num_symmetric),
                stream), f"K2 form {form}")
        return run

    def flat(pack, form, b, out, t0=0, nt=None):
        def run():
            checked(lib.probe_flat(
                form, *streams(pack), pack.step_start.data_ptr() + 4 * t0,
                X[b].data_ptr(), out.data_ptr(),
                pack.nt if nt is None else nt, pack.step, pack.tm,
                pack.w_pad, n, b, mm.column_tile(pack.w_pad, b, 2),
                int(pack.num_symmetric), stream), f"K6 form {form}")
        return run

    def chunk(pack, form, b, out):
        def run():
            checked(lib.probe_chunk(
                form, pack.vals.data_ptr(), pack.lrow.data_ptr(),
                pack.src.data_ptr(), X[b].data_ptr(), out.data_ptr(),
                pack.num_chunks, pack.s, pack.r_pad, n, b,
                mm.column_tile(pack.r_pad, b, 1), stream), f"K10 form {form}")
        return run

    M = csrc.from_assembly(n, *sm.band_arrays(
        n, sm.HALF_BAND, sm.FILL, args.seed + 101, True, dyadic=True))
    rpack = blockell.pack(M).to("cuda")
    M = csrc.from_assembly(n, *sm.skew_arrays(
        n, sm.SKEW_WIDE, sm.SKEW_NARROW, args.seed + 201, True,
        dyadic=True))
    fpack = fl.pack_flat(M).to("cuda")
    M = csrc.from_assembly(n, *sm.powerlaw_arrays(n, args.seed + 300,
                                                  dyadic=True))
    npack = nz.pack_nnzsplit(M, ks=8).to("cuda")
    del M
    steps = torch.diff(fpack.step_start.cpu())
    heavy = int(torch.nonzero(steps == 1)[0])     # tiles before the first
    if not bool((steps[:heavy] > 1).all()):       # one-step tile
        print("the wide band's tiles are not the first ones",
              file=sys.stderr)
        return 1

    def holds(name, got, want):
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            raise RuntimeError(f"{name} differs from its plain version "
                               f"(max abs err {err})")

    runs = {}
    for b in WIDTHS:
        out = torch.empty((rpack.nt, rpack.w_pad, b), device="cuda")
        want = mm.spmm_windows_stream_plain(rpack, X[b])
        for form, name in enumerate(WINDOW_FORMS):
            rect(rpack, form, b, out)()
            holds(f"K2 {name} B={b}", out, want)
            runs[f"k2_{name}_b{b}_ms"] = rect(rpack, form, b, out)
        del want
        out = torch.empty((fpack.nt, fpack.w_pad, b), device="cuda")
        want = fl.flat_windows_stream_plain(fpack, X[b])
        for form, name in enumerate(WINDOW_FORMS):
            flat(fpack, form, b, out)()
            holds(f"K6 {name} B={b}", out, want)
            runs[f"k6_{name}_b{b}_ms"] = flat(fpack, form, b, out)
            runs[f"k6_{name}_b{b}_heavy_ms"] = flat(fpack, form, b, out, 0,
                                                    heavy)
            runs[f"k6_{name}_b{b}_light_ms"] = flat(fpack, form, b, out,
                                                    heavy, fpack.nt - heavy)
        del want
        out = torch.empty((npack.num_chunks, npack.r_pad, b), device="cuda")
        want = nz.nnzsplit_partials_stream_plain(npack, X[b])
        for form, name in enumerate(CHUNK_FORMS):
            chunk(npack, form, b, out)()
            holds(f"K10 {name} B={b}", out, want)
            runs[f"k10_{name}_b{b}_ms"] = chunk(npack, form, b, out)
        del want
        torch.cuda.empty_cache()
    times = {name: [] for name in runs}
    for turn in range(4):
        for name in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            times[name].append(event_ms(runs[name]))
    heavy_steps = int(fpack.step_start[heavy])
    print(json.dumps({
        "n": n, "k2_slots": rpack.nt * rpack.s, "k6_tiles": fpack.nt,
        "k6_heavy_tiles": heavy, "k6_heavy_steps": heavy_steps,
        "k6_light_steps": fpack.total_steps - heavy_steps,
        "k10_chunks": npack.num_chunks, "k10_r_pad": npack.r_pad,
        "column_tiles": {f"b{b}": {
            "k2": mm.column_tile(rpack.w_pad, b, 2),
            "k6": mm.column_tile(fpack.w_pad, b, 2),
            "k10": mm.column_tile(npack.r_pad, b, 1)} for b in WIDTHS},
        **{name: float(np.median(times[name])) for name in runs},
        "runs": times, "sass": sass_atomics(lib_path),
        "card": device_mod.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
