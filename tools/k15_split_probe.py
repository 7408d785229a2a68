#!/usr/bin/env python3
"""K15 on the benchmark's Kronecker graph: the split of heavy rows at
several thresholds and chunk sizes, against the product without it.

    python3 tools/k15_split_probe.py [--scale 21] [--widths 1 8] \
        [--batch 1 4 8] [--heavy 16 32 64 128] [--chunk 128 256 512]

Needs one NVIDIA GPU and ``nvcc``.  Draws the graph of
``perfbench/configs/kron21-lgc.json`` at ``--scale`` (the generator's
seconds and its ``expected`` block are printed), binds it to the card and,
at each width, holds every form within 1e-5 of each row's absolute sum of
the plain chain (``csrc_segment.segment_product_plain``), then times each
with CUDA events, forms in turns, medians of five turns:

  unsplit            no row split: one launch of the row-owned kernel, the
                     product as it was before the split existed;
  b{U}/h{H}/c{C}     rows with more than H lower slots cut into chunks of C
                     slots: the row-owned and the chunk kernel, whose lanes
                     keep U gathers in flight (``kBatch``; the shipped value
                     as the source has it, the others built from copies in
                     the build directory under their own entry names).

Then a profile of ten products of the shipped form (HEAVY_SLOTS,
CHUNK_SLOTS) at each width: each kernel's device time a product.  Prints
one JSON line beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def shipped_batch(src: str) -> int:
    """kBatch as the chunk kernel's source sets it."""
    return int(re.search(r"constexpr int kBatch = (\d+);", src).group(1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--widths", type=int, nargs="+", default=(1, 8))
    ap.add_argument("--batch", type=int, nargs="+", default=(1, 4, 8))
    ap.add_argument("--heavy", type=int, nargs="+",
                    default=(16, 32, 64, 128))
    ap.add_argument("--chunk", type=int, nargs="+",
                    default=(128, 256, 512))
    args = ap.parse_args()

    import numpy as np
    import torch

    from perfbench.harness import spec
    from repro_torch.core import csrc
    from repro_torch.kernels import _build
    from repro_torch.kernels import csrc_segment as seg

    if not torch.cuda.is_available():
        print("k15_split_probe: needs one NVIDIA GPU", file=sys.stderr)
        return 1
    gen = spec.generator("kron")
    cfg = dict(spec._json("configs", "kron21-lgc.json"), scale=args.scale)
    t0 = time.perf_counter()
    arrays = gen.build(cfg)
    generate_s = time.perf_counter() - t0
    summary = gen.summary(arrays)
    n = arrays["n"]
    M = csrc.from_assembly(n, arrays["ia"], arrays["ja"], arrays["ad"],
                           arrays["al"], arrays["au"]).to("cuda")
    Ma = csrc.from_assembly(n, arrays["ia"], arrays["ja"], arrays["ad"],
                            np.abs(arrays["al"]), np.abs(arrays["au"])
                            ).to("cuda")
    lengths = np.diff(arrays["ia"])
    # the chunk kernel at each batch, a copy of the source under its own
    # entry name where the batch is not the shipped one
    src = open(seg.K15.source).read()
    shipped_line = f"constexpr int kBatch = {shipped_batch(src)};"
    os.makedirs(_build.build_dir(), exist_ok=True)
    entries = {}
    for u in args.batch:
        if shipped_line == f"constexpr int kBatch = {u};":
            entries[u] = seg.K15
            continue
        path = os.path.join(_build.build_dir(), f"k15_batch{u}.cu")
        with open(path, "w") as f:
            f.write(src.replace(shipped_line, f"constexpr int kBatch = {u};")
                    .replace("int csrc_segment_spmm(",
                             f"int k15_batch{u}("))
        entries[u] = _build.Kernel(f"k15_batch{u}", seg.K15.argtypes,
                                   replaces="")
        entries[u].source = path
    _build.build([k for k in entries.values() if k is not seg.K15])

    def launcher(entry, bound):
        def product(x):
            nrhs = 1 if x.ndim == 1 else x.shape[1]
            y = torch.empty(tuple(x.shape), device="cuda")
            vec, lanes = seg.lane_mapping(nrhs, x.data_ptr(), y.data_ptr())
            entry.launch(*bound._arrays, x.data_ptr(), y.data_ptr(), n, n,
                         nrhs, vec, lanes, *bound._last_args)
            return y
        return product

    bound = {"unsplit": seg.SegmentKernel(
        M, seg.split_rows(M.ia, heavy=2**31 - 1))}
    forms = {"unsplit": bound["unsplit"]}
    for h in args.heavy:
        for c in args.chunk:
            bound[f"h{h}/c{c}"] = k = seg.SegmentKernel(
                M, seg.split_rows(M.ia, h, c))
            for u, entry in entries.items():
                forms[f"b{u}/h{h}/c{c}"] = launcher(entry, k)
    split = {name: {"rows": k.split.rows, "slots": k.split.slots,
                    "chunks": int(k.split.chunks.shape[0])}
             for name, k in bound.items()}
    rng = np.random.default_rng(0)

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
    for width in args.widths:
        shape = (n,) if width == 1 else (n, width)
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).cuda()
        want = seg.segment_product_plain(M, x)
        bound = 1e-5 * seg.segment_product_plain(Ma, x.abs()) + 1e-30
        worst = {}
        for name, k in forms.items():
            err = ((k(x) - want).abs() / bound).max().item() * 1e-5
            worst[name] = err
            if not err <= 1e-5:
                print(f"k15_split_probe: {name} at B = {width} reads {err} "
                      "of the row's absolute sum", file=sys.stderr)
                return 1
        del want, bound
        times = {name: [] for name in forms}
        names = list(forms)
        for turn in range(5):
            for name in (names if turn % 2 == 0 else names[::-1]):
                times[name].append(event_ms(lambda: forms[name](x)))
        shipped = seg.SegmentKernel(M)
        from torch.profiler import ProfilerActivity, profile
        shipped(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                shipped(x)
            torch.cuda.synchronize()
        kernels = {e.key[:80]: e.device_time_total / 10 / 1e3
                   for e in prof.key_averages() if e.device_time_total > 0}
        out[f"B{width}"] = {
            "ms": {name: statistics.median(t) for name, t in times.items()},
            "max_err_rowsum": worst, "kernels_ms": kernels}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "k15_split_probe": out, "scale": args.scale,
        "generate_s": generate_s, "expected": summary, "split": split,
        "rows_over": {str(h): int((lengths > h).sum()) for h in args.heavy},
        "shipped": {"batch": shipped_batch(open(seg.K15.source).read()),
                    "heavy": seg.HEAVY_SLOTS, "chunk": seg.CHUNK_SLOTS},
        "card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
