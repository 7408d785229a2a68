"""The benchmark of repro_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card.  The cell's
configuration, traffic, limits and metrics are found by name (see
``harness/spec.py``).  The last line of standard output is the result: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers are
the last lines of standard error.  Without a card, or with fewer cards than
the cell asks for, it prints no result and exits 2; with JAX or the JAX
package loaded once the window has closed, it exits 3; where a device
activity of the traced slice cannot be matched to its launch, it exits 4.

Two modes set the limits and are not part of a run:

    --readings SEED,SEED,...   the compared numbers on each seed after one
                               set-up (the program's, or with --control the
                               control's)
    --control bf16             the reference one precision down in the
                               program's place; its runs must read
                               ``correct: false``

The kernels' build directory and the plan cache stay in ``perfbench/cache``
(ignored by git), so only a checkout's first run builds and packs.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)
# every build and kernel cache at a fixed path inside the checkout
os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(CACHE, "build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    ap.add_argument("--readings", default=None,
                    help="comma-separated seeds: print the compared "
                         "numbers of each and exit")
    args = ap.parse_args(argv)

    import torch
    from perfbench.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device (torch.cuda.is_available() is "
              "False); the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    if args.readings:
        seeds = [int(s) for s in args.readings.split(",") if s]
        runner.readings(cell, seeds, control=args.control)
        return 0
    code, result = runner.run(cell, args.seed, args.seconds,
                              bool(args.trace), T_START,
                              control=args.control)
    if result is None:
        return code or 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
