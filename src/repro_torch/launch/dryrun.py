"""Dry-run of every (architecture × input shape × mesh) cell on the meta
device: what each device of the mesh would hold, from shapes alone.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh both --out results/dryrun [--device cpu]

The JAX package lowers and compiles each cell on 512 placeholder devices
and reads memory and costs off the compiled module.  Here nothing is
compiled and no device is faked: each arch is built once on ``meta``
(``build_model(cfg, device="meta")``), its params tree taken in the
stacked layout (``convert.lm_params_tree``) and sharded by the rules of
``models/sharding.py`` on the mesh's axis sizes.  Per cell it records the
bytes one device holds — weights under the training placement (FSDP over
``data``, tensor parallel over ``model``), AdamW's float32 moments (train
cells), the decode state under ``decode_state_specs`` (decode cells), the
inputs (batch over ``pod``/``data``) — the weights under the serving
placement (``_strip_axis``: replicated over ``data``), ``model_flops`` and
the roofline terms (``roofline/analysis.py``) with the card's denominators:
HBM bandwidth from ``cost_model.calibrate(device)`` (measured once on the
card; the data sheet with ``--device cpu``).  Fields only a compiled
module gives (lowering and compile seconds, XLA's flops and bytes
accessed, temporaries, collective bytes) are null.  The whole 80-cell run
takes seconds on the host.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict

from repro_torch import convert, tree
from repro_torch.configs.base import get_config, registry
from repro_torch.configs.shapes import SHAPES, cell_supported, input_specs
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models.sharding import P, guard_spec, infer_param_specs
from repro_torch.models.transformer import build_model
from repro_torch.roofline.analysis import Roofline, model_flops

MESHES = {"16x16": False, "2x16x16": True}


def _strip_axis(spec_tree, axis: str):
    """Remove one mesh axis from every spec (serving placement: weights
    replicated over ``data``, sharded over ``model`` only)."""
    def strip(spec):
        out = []
        for e in spec:
            if e == axis:
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a != axis)
                out.append(kept if kept else None)
            else:
                out.append(e)
        return P(*out)

    return tree.map(strip, spec_tree)


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of ``t`` on one device under ``spec`` guarded on ``mesh``."""
    sizes = mesh.shape
    split = 1
    for e in guard_spec(spec, t.shape, mesh):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            split *= sizes[a]
    return t.numel() * t.element_size() // split


def tree_bytes(tensors, specs, mesh) -> int:
    return sum(shard_bytes(t, s, mesh) for t, s in zip(
        tree.leaves(tensors), tree.leaves(specs), strict=True))


def _batch_spec(mesh) -> P:
    """inputs / targets: batch over (pod, data)."""
    ba = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return P(ba) if ba else P()


class _Arch:
    """One arch built on meta: the model and its stacked params tree."""

    def __init__(self, arch: str):
        self.cfg = get_config(arch)
        self.model = build_model(self.cfg, device="meta")
        self.params = convert.lm_params_tree(self.model.state_dict())


def lower_cell(arch: str, shape_name: str, mesh: MeshShape,
               mesh_name: str = None, built: _Arch = None,
               hbm_bw: float = None, verbose: bool = False) -> Dict:
    """One cell's record (the JAX package's keys; null where only a
    compiled module could say)."""
    from repro_torch.launch.mesh import HBM_BW_DATA_SHEET
    mesh_name = mesh_name or mesh.name
    built = built or _Arch(arch)
    cfg, shape = built.cfg, SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    t0 = time.perf_counter()
    specs = input_specs(cfg, shape, built.model)
    param_specs = infer_param_specs(built.params, mesh)
    per_device = {"params": tree_bytes(built.params, param_specs, mesh)}
    if shape.kind == "train":
        # AdamW's m and v: float32, placed as the weights
        per_device["moments"] = 2 * sum(
            shard_bytes(t, s, mesh) * 4 // t.element_size()
            for t, s in zip(tree.leaves(built.params),
                            tree.leaves(param_specs), strict=True))
    else:
        per_device["serve_params"] = tree_bytes(
            built.params, _strip_axis(param_specs, "data"), mesh)
    if shape.kind == "decode":
        state_specs = built.model.decode_state_specs(
            batch_axes=tuple(a for a in ("pod", "data")
                             if a in mesh.axis_names),
            model_size=mesh.shape.get("model", 1))
        per_device["decode_state"] = tree_bytes(specs["state"], state_specs,
                                                mesh)
    per_device["inputs"] = sum(
        shard_bytes(specs[k], _batch_spec(mesh), mesh)
        for k in ("inputs", "targets") if k in specs)
    resident = sum(v for k, v in per_device.items() if k != "serve_params")
    flops = model_flops(cfg, shape)
    roof = Roofline(arch=arch, shape=shape_name, mesh=mesh_name,
                    chips=mesh.size, hlo_flops=flops / mesh.size,
                    hlo_bytes=float(resident), collective_bytes=None,
                    model_flops=flops).finalize(hbm_bw or HBM_BW_DATA_SHEET)
    seconds = time.perf_counter() - t0
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": mesh.size,
        "lower_s": None, "compile_s": None, "meta_s": round(seconds, 4),
        "cost": {"flops": None, "bytes accessed": None},
        "memory": {"argument_size_in_bytes": resident,
                   "output_size_in_bytes": None,
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None,
                   "alias_size_in_bytes": None},
        "per_device_bytes": per_device,
        "roofline": roof.to_dict(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
              f"({resident / 1e9:.3f} GB a device, "
              f"bottleneck={roof.bottleneck})", flush=True)
    return rec


def run(archs, shapes, meshes, hbm_bw: float, out_dir: str = None,
        verbose: bool = False):
    """Every (arch × shape × mesh) cell; each record written to
    ``out_dir`` (when given) as ``<arch>__<shape>__<mesh>.json``.
    Returns the records; a cell that raises is recorded as failed."""
    records = []
    for arch in archs:
        built = None
        for shape_name in shapes:
            for mesh_name in meshes:
                try:
                    built = built or _Arch(arch)
                    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
                    rec = lower_cell(arch, shape_name, mesh, mesh_name,
                                     built=built, hbm_bw=hbm_bw,
                                     verbose=verbose)
                except Exception as e:   # record the failure, keep going
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "failed",
                           "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
                          f"FAILED {e!r}", flush=True)
                records.append(rec)
                if out_dir:
                    path = os.path.join(
                        out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
    return records


def main(argv=None) -> int:
    from repro_torch.roofline import cost_model
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="whose HBM bandwidth the roofline divides by "
                         "(cuda: measured on the card; cpu: the data "
                         "sheet)")
    args = ap.parse_args(argv)
    archs = sorted(registry()) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": list(MESHES)}[args.mesh]
    bw = cost_model.calibrate(args.device).hbm_bw
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    records = run(archs, shapes, meshes, bw, args.out, verbose=True)
    failures = sum(r["status"] == "failed" for r in records)
    print(f"[dryrun] done: {len(records)} cells, {failures} failures, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
