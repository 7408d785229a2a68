#!/usr/bin/env python3
"""K15, the ``segment`` path's one-pass product, against its other lane
mappings and an evict-first form, at the benchmark cube's shape.

    python3 tools/k15_body_probe.py [--grid 112 112 112] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds HPCG's 27-point stencil on the
grid (``chip_smoke.stencil27_arrays``: n = 1,404,928, k = 17,927,388 at
112^3), binds it to the card, holds every form equal to the plain chain
(``csrc_segment.segment_product_plain``) on dyadic x, then times each with
CUDA events, forms in turns, medians of five turns:

  shipped/vec{V}/lanes{L}
          K15 as it ships (``csrc/csrc_segment_spmm.cu``), launched with
          V columns a lane and L lanes a row: at B = 8 the shipped mapping
          (4, 2), and (2, 4), (1, 8) and one lane walking both 16-byte
          groups (4, 1); at B = 1 the one mapping (1, 1);
  ldcs/vec{V}/lanes{L}
          the same source with ``ja``, ``al`` and ``au`` loaded
          evict-first (``__ldcs``) instead of through the read-only path,
          built from a copy in the build directory.

Then the host's side of one B = 1 product: microseconds to issue a call
of the bound wrapper (``SegmentKernel``, as the ``segment`` operator calls
it) and of the bare launch (``torch.empty`` and ``K15.launch`` with the
arguments ready), each over bursts of 50 calls too few to fill the launch
queue, medians of 40 bursts.  Their difference is the wrapper's own cost.

Prints one JSON line: per width each form's median ms, the host
microseconds a call, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, nargs=3, default=(112, 112, 112))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import csrc
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import csrc_segment as seg

    if not torch.cuda.is_available():
        print("k15_body_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    # the evict-first copy, under its own entry name
    src = open(seg.K15.source).read()
    ldcs = src
    for a in ("ja", "al", "au"):
        ldcs = ldcs.replace(f"__ldg({a} + p)", f"__ldcs({a} + p)")
    os.makedirs(_build.build_dir(), exist_ok=True)
    path = os.path.join(_build.build_dir(), "k15_ldcs.cu")
    with open(path, "w") as f:
        f.write(ldcs.replace("int csrc_segment_spmm(", "int k15_ldcs("))
    k_ldcs = _build.Kernel("k15_ldcs", seg.K15.argtypes, replaces="")
    k_ldcs.source = path
    kernels = {"shipped": seg.K15, "ldcs": k_ldcs}
    _build.build(list(kernels.values()))

    nx, ny, nz = args.grid
    n = nx * ny * nz
    M = csrc.from_assembly(n, *cs.stencil27_arrays(nx, ny, nz)).to("cuda")
    bound = seg.SegmentKernel(M)
    row_idx = ref.row_index(M)
    rng = np.random.default_rng(args.seed)

    def run(name, x, vec, lanes):
        nrhs = 1 if x.ndim == 1 else x.shape[1]
        y = torch.empty((n,) + tuple(x.shape[1:]), device="cuda")
        kernels[name].launch(*bound._arrays, x.data_ptr(), y.data_ptr(), n,
                             n, nrhs, vec, lanes, *bound._last_args)
        return y

    def event_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    out = {}
    for width, maps in ((1, [(1, 1)]),
                        (8, [(4, 2), (2, 4), (1, 8), (4, 1)])):
        shape = (n,) if width == 1 else (n, width)
        x = torch.from_numpy(cs.dyadic_vector(rng, shape)).cuda()
        want = seg.segment_product_plain(M, x, row_idx=row_idx)
        forms = [(k, v, lanes) for k in kernels for v, lanes in maps]
        for form in forms:
            if not torch.equal(run(form[0], x, form[1], form[2]), want):
                print(f"k15_body_probe: {form} differs from the plain chain",
                      file=sys.stderr)
                return 1
        times = {form: [] for form in forms}
        for turn in range(5):
            for form in (forms if turn % 2 == 0 else forms[::-1]):
                times[form].append(event_ms(
                    lambda: run(form[0], x, form[1], form[2])))
        out[f"B{width}"] = {f"{k}/vec{v}/lanes{lanes}":
                            statistics.median(t)
                            for (k, v, lanes), t in times.items()}
    x = torch.from_numpy(cs.dyadic_vector(rng, (n,))).cuda()
    head = (*bound._arrays, x.data_ptr())
    tail = (n, n, 1, 1, 1, *bound._last_args)

    def bare():
        y = torch.empty(n, device="cuda")
        seg.K15.launch(*head, y.data_ptr(), *tail)

    def host_us(fn, calls=50, bursts=40):
        per = []
        for _ in range(bursts + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(per[1:])

    samples = {"wrapper": [], "bare": []}
    for turn in range(6):
        for name in (("wrapper", "bare") if turn % 2 == 0
                     else ("bare", "wrapper")):
            samples[name].append(host_us(
                (lambda: bound(x)) if name == "wrapper" else bare))
    out["host_us_B1"] = {k: statistics.median(v) for k, v in samples.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"k15_body_probe": out, "grid": list(args.grid),
                      "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
