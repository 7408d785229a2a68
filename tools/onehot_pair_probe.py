#!/usr/bin/env python3
"""Each stream / one-hot kernel pair on one pack, timed side by side, with
the pack features card pricing reads.

    python3 tools/onehot_pair_probe.py [--n 2097152] [--seed 0]

Needs one NVIDIA GPU and ``nvcc``.  Builds ``chip_smoke.py``'s six main-path
matrices (``fem_ns`` / ``fem_sym`` on the rectangular grid, ``skew_ns`` /
``skew_sym`` on the flat grid, ``pl_sym`` / ``rand_ns`` on nnz-split chunks,
each at tm 128 and ks 8) and, on each pack, times both variants of the
kernels (K1/K3 and K2/K4, K5/K7 and K6/K8, K9/K11 and K10/K12) at B = 1, 8
and 11 with CUDA events on standard-normal x.  Beside each pair it prints
the pack's geometry (``cost_model.pack_geometry``) and the card prices of
both plans on it, so the one-hot body term of card pricing can be read
against what the card does.  Prints one JSON line per pack and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

WIDTHS = (1, 8, 11)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2_097_152)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import device as device_mod
    from repro_torch.core import csrc, tuner
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import SpmvOperator
    from repro_torch.roofline import cost_model

    _build.build()
    den = cost_model.calibrate("cuda")
    rng = np.random.default_rng(args.seed)
    for spec in cs.path_specs(args.n, args.seed):
        path = spec["name"]
        for mid, make in spec["matrices"].items():
            M = csrc.from_assembly(args.n, *make())
            stats = tuner.stats_of(M)
            plan = ExecutionPlan(path=path, variant="stream")
            op = SpmvOperator.from_plan(M, plan, device="cuda")
            pack = op.pack
            runners = cs._runners(pack, plan.k_step_sublanes)
            geom = cost_model.pack_geometry(pack)
            out = {"path": path, "matrix": mid, "n": args.n,
                   "geometry": dataclasses.asdict(geom), "pairs": []}
            for nrhs in WIDTHS:
                shape = (args.n,) if nrhs == 1 else (args.n, nrhs)
                x = torch.from_numpy(rng.standard_normal(
                    shape, dtype=np.float32)).cuda()
                width = "spmv" if nrhs == 1 else "spmm"
                grid = "blockell" if path == "kernel" else path
                ms, price = {}, {}
                for variant in ("stream", "onehot"):
                    kernel = runners[f"{grid}_{width}_{variant}"][0]
                    ms[variant] = cs.time_ms(lambda: kernel(x))
                    p = dataclasses.replace(plan, variant=variant,
                                            nrhs=nrhs)
                    est = cost_model.card_plan_cost(stats, p, den,
                                                    geometry=geom)
                    price[variant] = est.predicted_s * 1e3
                out["pairs"].append({
                    "nrhs": nrhs, "ms": ms, "predicted_ms": price,
                    "measured_ratio": ms["onehot"] / ms["stream"],
                    "predicted_ratio": price["onehot"] / price["stream"]})
                del x
            print(json.dumps(out), flush=True)
            del op, pack, runners, M
            torch.cuda.empty_cache()
    print(device_mod.power_limit(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
