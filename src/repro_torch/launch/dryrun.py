"""Dry-run of every (architecture × input shape × mesh) cell on the meta
device: what each device of the mesh holds, and what the cell's own step
computes, traced op by op.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
      --shape all --mesh both --out results/dryrun [--device cpu] \
      [--remat none|full|dots] [--microbatches N] [--bf16-moments] \
      [--kv-quant] [--serve-tp-only] [--ssd-chunked] \
      [--moe-constrained [constrain|hierarchical]] [--variant NAME] \
      [--skip-existing]

The JAX package lowers and compiles each cell on 512 placeholder devices
and reads memory and costs off the compiled module.  Here nothing is
compiled and no device is faked: each arch is built once on ``meta``
(``build_model(cfg, device="meta")``), its params tree taken in the
stacked layout (``convert.lm_params_tree``) and sharded by the rules of
``models/sharding.py`` on the mesh's axis sizes.  Per cell it records the
bytes one device holds — weights under the training placement (FSDP over
``data``, tensor parallel over ``model``), AdamW's moments in their dtype
(train cells), the decode state under ``decode_state_specs`` (decode
cells), the inputs (batch over ``pod``/``data``) — and the weights under
the serving placement (``_strip_axis``: replicated over ``data``).

The compiled module's half comes from ``roofline/trace.py``: the cell's
step (``make_train_step``, ``model.prefill`` or ``model.decode_step``)
runs on meta under the tracer for ONE device's inputs — the batch divided
over the batch axes as ``_batch_spec`` and ``guard_spec`` divide it — with
the weights at their gathered shapes (what FSDP gathers before use), rolled
up over layers, microbatches and scan lengths (``trace.rollup``; which
counts repeat and which functions are scans is said here: ``_units``,
``_unit_map``, ``_SCANS``).  Per
device (``PER_DEVICE_METHOD``): ``cost.flops`` and ``cost["bytes
accessed"]`` are the trace's over the ``model`` axis size;
``memory.temp_size_in_bytes`` is the trace's peak of temporaries,
undivided (an upper bound: the model axis splits none of the
activations), with the outputs live at the peak in it, where XLA's
temporaries leave them out (``memory.temp_includes_outputs``);
``memory.output_size_in_bytes`` the trace's outputs, undivided.  The roofline divides these (``roofline/analysis.py``) by the
card's peak and its HBM bandwidth from ``cost_model.calibrate(device)``
(measured once on the card; the data sheet with ``--device cpu``).  Still
null: lowering and compile seconds (nothing is compiled) and collective
bytes (no partitioner exists; ROADMAP C40).

The levers are the JAX package's (``src/repro/launch/dryrun.py:204-216``),
each set for its cell and restored after it (:class:`Levers`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

from repro_torch import convert, tree
from repro_torch.configs.base import get_config, registry
from repro_torch.configs.shapes import (SHAPES, InputShape, cell_supported,
                                        input_specs)
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models.sharding import P, guard_spec, infer_param_specs
from repro_torch.models.transformer import build_model
from repro_torch.roofline.analysis import Roofline, model_flops

MESHES = {"16x16": False, "2x16x16": True}

PER_DEVICE_METHOD = (
    "one device's step traced on meta: the batch divided over the batch "
    "axes (guard_spec), weights at their gathered shapes; cost.flops and "
    "cost['bytes accessed'] = the trace's / the model axis size; "
    "memory.temp_size_in_bytes = the trace's peak of storages created in "
    "the step, outputs live at the peak included, undivided (an upper "
    "bound: the model axis splits no activation); "
    "memory.output_size_in_bytes = the trace's outputs, undivided")


@dataclasses.dataclass(frozen=True)
class Levers:
    """The JAX package's experiment levers.  ``microbatches`` None is the
    default: 8 for train cells (``_microbatches_for``)."""
    remat: str = "full"
    microbatches: Optional[int] = None
    serve_tp_only: bool = False
    moe_constrained: object = False      # False | "constrain" | "hierarchical"
    kv_quant: bool = False
    bf16_moments: bool = False
    ssd_chunked: bool = False

    def microbatches_for(self, shape) -> int:
        if shape.kind != "train":
            return 1
        return self.microbatches or 8


@contextlib.contextmanager
def levers_applied(levers: Levers):
    """The module switches of ``levers`` (the MoE dispatch, the chunked
    scans) set for the block and restored after it."""
    from repro_torch.models import mamba2, moe, rwkv6
    saved = (moe.CONSTRAIN_DISPATCH, mamba2.CHUNKED_SSD, rwkv6.CHUNKED_WKV)
    moe.CONSTRAIN_DISPATCH = levers.moe_constrained
    mamba2.CHUNKED_SSD = bool(levers.ssd_chunked)
    rwkv6.CHUNKED_WKV = bool(levers.ssd_chunked)
    try:
        yield
    finally:
        moe.CONSTRAIN_DISPATCH, mamba2.CHUNKED_SSD, rwkv6.CHUNKED_WKV = saved


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


def _split(spec, shape, mesh) -> int:
    """How many ways ``spec`` guarded on ``mesh`` splits ``shape``."""
    sizes = mesh.shape
    split = 1
    for e in guard_spec(spec, shape, mesh):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            split *= sizes[a]
    return split


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of ``t`` on one device under ``spec`` guarded on ``mesh``."""
    return t.numel() * t.element_size() // _split(spec, t.shape, mesh)


def tree_bytes(tensors, specs, mesh) -> int:
    return sum(shard_bytes(t, s, mesh) for t, s in zip(
        tree.leaves(tensors), tree.leaves(specs), strict=True))


def _batch_spec(mesh) -> P:
    """inputs / targets: batch over (pod, data)."""
    ba = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return P(ba) if ba else P()


def local_batch(shape, mesh) -> int:
    """One device's share of the cell's batch."""
    return shape.batch // _split(_batch_spec(mesh), (shape.batch,), mesh)


class _Arch:
    """One arch built on meta: the model and its stacked params tree."""

    def __init__(self, arch: str, kv_quant: bool = False):
        cfg = get_config(arch)
        if kv_quant:
            cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
        self.cfg = cfg
        self.model = build_model(self.cfg, device="meta")
        self.params = convert.lm_params_tree(self.model.state_dict())


# ---------------------------------------------------------------------------
# The traced step of one device
# ---------------------------------------------------------------------------

def _units(cfg) -> int:
    """How many repeated units (scanned layers, or the hybrid's groups)
    ``cfg`` runs."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.n_layers - (cfg.moe.first_dense if cfg.moe else 0)


def _with_units(cfg, n: int):
    """A copy of ``cfg`` with ``n`` repeated units, all else kept."""
    if cfg.family == "hybrid":
        tail = cfg.n_layers % cfg.hybrid_period
        return dataclasses.replace(cfg, n_layers=n * cfg.hybrid_period + tail)
    first = cfg.moe.first_dense if cfg.moe else 0
    return dataclasses.replace(cfg, n_layers=first + n)


# stacked leaves of the params tree (``convert.lm_params_tree``) whose
# leading axis is the repeated unit; the hybrid's unit is a group
_UNIT_STACKS = {"dense": ("layers",), "audio": ("layers",),
                "vlm": ("layers",), "moe": ("layers",),
                "ssm": ("layers",), "hybrid": ("mamba_groups", "lora")}


def _unit_map(cfg, params=None, model=None):
    """The tracer's units (``trace.Tracer``): the storage keys of the
    repeated units' weights, the stacked leaves of ``params`` (one unit
    per slice of the leading axis) and the per-layer weights of ``model``
    (its state dict: ``layers.<i>.``, ``mamba_groups.<g>.``,
    ``lora.<g>.``)."""
    names = _UNIT_STACKS[cfg.family]
    units = {}
    if params is not None:
        for name in names:
            for leaf in tree.leaves(params[name]):
                n = leaf.shape[0]
                units[leaf.untyped_storage()._cdata] = (
                    max(1, leaf.numel() * leaf.element_size() // n), 0)
    if model is not None:
        for key, t in model.state_dict().items():
            head, _, rest = key.partition(".")
            if head in names and rest:
                j = int(rest.split(".")[0])
                units[t.untyped_storage()._cdata] = (
                    t.untyped_storage().nbytes() + 1, j)
    return units


def _scans():
    """The recurrent and chunked scans that the rollup fits by length
    (``trace.rolled_scans``), each with its time unit."""
    from repro_torch.models import mamba2, rwkv6
    return ((mamba2, "_ssd_recurrent", lambda: 1),
            (mamba2, "_ssd_chunked", lambda: mamba2.SSD_CHUNK),
            (rwkv6, "_wkv_recurrent", lambda: 1),
            (rwkv6, "_wkv_chunked", lambda: rwkv6.WKV_CHUNK))


def trace_step(cfg, kind: str, batch: int, seq: int, levers: Levers,
               microbatches: int = 1, opt_cfg=None):
    """One trace of the cell's step for ``cfg`` as it is (no rollup of
    the repeat counts): train ``make_train_step`` (AdamW ``opt_cfg``, by
    default the defaults with the levers' moment dtype), prefill
    ``model.prefill``, decode ``model.decode_step`` on meta inputs of
    ``batch`` x ``seq``.  Run it inside :func:`levers_applied`."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import trace
    from repro_torch.train.step import init_train_state, make_train_step
    model = build_model(cfg, device="meta")
    specs = input_specs(cfg, InputShape(kind, kind, seq, batch), model)
    if kind == "train":
        opt_cfg = opt_cfg or AdamWConfig(
            moment_dtype="bfloat16" if levers.bf16_moments else "float32")
        state = init_train_state(model, opt_cfg)
        step = make_train_step(model, opt_cfg, microbatches=microbatches,
                               remat=levers.remat)
        return trace.trace_fn(
            step, state, {"inputs": specs["inputs"],
                          "targets": specs["targets"]},
            units=_unit_map(cfg, params=state.params),
            n_units=_units(cfg))
    units = _unit_map(cfg, model=model)
    if kind == "prefill":
        return trace.trace_fn(model.prefill, specs["inputs"], seq,
                              units=units, n_units=_units(cfg))
    return trace.trace_fn(model.decode_step, specs["state"],
                          specs["inputs"], units=units, n_units=_units(cfg))


def trace_cell(cfg, kind: str, batch: int, seq: int, levers: Levers,
               microbatches: int = 1, rollup: bool = True, opt_cfg=None):
    """The cell's step traced for one device: with ``rollup`` the repeat
    counts (units, microbatches) are traced at 2 and 3 and extrapolated
    and the scans rolled (``trace.rollup``, ``trace.rolled_scans`` of
    :func:`_scans`);
    without, one trace of the whole step."""
    from repro_torch.roofline import trace
    with levers_applied(levers):
        if not rollup:
            return trace_step(cfg, kind, batch, seq, levers, microbatches,
                              opt_cfg)

        if batch % microbatches:
            raise ValueError(f"batch {batch} must divide into "
                             f"{microbatches} microbatches")

        def at(units, mb):
            return trace_step(_with_units(cfg, units), kind, batch * mb
                              // microbatches, seq, levers, mb, opt_cfg)

        with trace.rolled_scans(_scans()):
            return trace.rollup(at, [(_units(cfg), (2, 3)),
                                     (microbatches, (2, 3))])


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def lower_cell(arch: str, shape_name: str, mesh: MeshShape,
               mesh_name: str = None, built: _Arch = None,
               hbm_bw: float = None, verbose: bool = False,
               levers: Levers = Levers(), trace: bool = True,
               cache: Dict = None) -> Dict:
    """One cell's record (the JAX package's keys).  ``trace`` False
    leaves the compiled half and the roofline's terms null (resident
    bytes only, for callers that read nothing else); ``cache`` shares
    traces between cells whose one-device step is the same."""
    from repro_torch.launch.mesh import HBM_BW_DATA_SHEET
    mesh_name = mesh_name or mesh.name
    built = built or _Arch(arch, levers.kv_quant)
    cfg, shape = built.cfg, SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    t0 = time.perf_counter()
    specs = input_specs(cfg, shape, built.model)
    param_specs = infer_param_specs(built.params, mesh)
    serve_specs = _strip_axis(param_specs, "data")
    if levers.serve_tp_only and shape.kind != "train":
        per_device = {"params": tree_bytes(built.params, serve_specs, mesh)}
    else:
        per_device = {"params": tree_bytes(built.params, param_specs, mesh)}
    if shape.kind == "train":
        # AdamW's m and v in their dtype, placed as the weights
        msize = 2 if levers.bf16_moments else 4
        per_device["moments"] = 2 * sum(
            shard_bytes(t, s, mesh) * msize // t.element_size()
            for t, s in zip(tree.leaves(built.params),
                            tree.leaves(param_specs), strict=True))
    elif not levers.serve_tp_only:
        per_device["serve_params"] = tree_bytes(built.params, serve_specs,
                                                mesh)
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
    model_size = mesh.shape.get("model", 1)
    mb = levers.microbatches_for(shape)
    tr = None
    if trace:
        key = (arch, shape.kind, local_batch(shape, mesh), shape.seq, mb,
               levers)
        if cache is not None and key in cache:
            tr = cache[key]
        else:
            tr = trace_cell(cfg, shape.kind, local_batch(shape, mesh),
                            shape.seq, levers, mb)
            if cache is not None:
                cache[key] = tr
    cost = ({"flops": tr.flops / model_size,
             "bytes accessed": tr.bytes_accessed / model_size}
            if tr else {"flops": None, "bytes accessed": None})
    roof = Roofline(arch=arch, shape=shape_name, mesh=mesh_name,
                    chips=mesh.size,
                    hlo_flops=cost["flops"],
                    hlo_bytes=cost["bytes accessed"],
                    collective_bytes=None,
                    model_flops=flops).finalize(hbm_bw or HBM_BW_DATA_SHEET)
    seconds = time.perf_counter() - t0
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": mesh.size,
        "lower_s": None, "compile_s": None, "meta_s": round(seconds, 4),
        "cost": cost,
        "memory": {"argument_size_in_bytes": resident,
                   "output_size_in_bytes": (int(tr.output_bytes) if tr
                                            else None),
                   "temp_size_in_bytes": (int(tr.peak_temp_bytes) if tr
                                          else None),
                   "temp_includes_outputs": True if tr else None,
                   "generated_code_size_in_bytes": None,
                   "alias_size_in_bytes": None},
        "per_device_bytes": per_device,
        "roofline": roof.to_dict(),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "levers": dict(dataclasses.asdict(levers), microbatches=mb),
    }
    if tr:
        rec["trace"] = dict(tr.to_dict(), batch=local_batch(shape, mesh),
                            model_axis=model_size,
                            per_device_method=PER_DEVICE_METHOD)
        if levers.moe_constrained == "constrain":
            rec["trace"]["moe_constrained"] = (
                "constrain: the same computation; sharding.constrain is the "
                "identity on one device")
    if verbose:
        extra = (f", {tr.flops / model_size:.4g} flops and "
                 f"{tr.peak_temp_bytes / 1e9:.3f} GB of temporaries a "
                 f"device, traced in {tr.seconds:.2f} s" if tr else "")
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
              f"({resident / 1e9:.3f} GB resident a device{extra}, "
              f"bottleneck={roof.bottleneck})", flush=True)
    return rec


def cell_path(out_dir: str, arch: str, shape_name: str, mesh_name: str,
              variant: str = None) -> str:
    suffix = f"__{variant}" if variant else ""
    return os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")


def run(archs, shapes, meshes, hbm_bw: float, out_dir: str = None,
        verbose: bool = False, levers: Levers = Levers(),
        trace: bool = True, variant: str = None,
        skip_existing: bool = False):
    """Every (arch × shape × mesh) cell; each record written to
    ``out_dir`` (when given) as ``<arch>__<shape>__<mesh>[__<variant>].json``
    (a cell whose file exists is skipped with ``skip_existing``).
    Returns the records; a cell that raises is recorded as failed."""
    records = []
    cache: Dict = {}
    for arch in archs:
        built = None
        for shape_name in shapes:
            for mesh_name in meshes:
                path = (cell_path(out_dir, arch, shape_name, mesh_name,
                                  variant) if out_dir else None)
                if skip_existing and path and os.path.exists(path):
                    continue
                try:
                    built = built or _Arch(arch, levers.kv_quant)
                    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
                    rec = lower_cell(arch, shape_name, mesh, mesh_name,
                                     built=built, hbm_bw=hbm_bw,
                                     verbose=verbose, levers=levers,
                                     trace=trace, cache=cache)
                except Exception as e:   # record the failure, keep going
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "failed",
                           "error": repr(e),
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
                          f"FAILED {e!r}", flush=True)
                if variant:
                    rec["variant"] = variant
                records.append(rec)
                if path:
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
    ap.add_argument("--skip-existing", action="store_true")
    # the JAX package's experiment levers
    ap.add_argument("--variant", default=None,
                    help="suffix for result files (experiments)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--serve-tp-only", action="store_true")
    ap.add_argument("--moe-constrained", default=False, nargs="?",
                    const="constrain", choices=["constrain", "hierarchical"],
                    help="'constrain' or 'hierarchical' dispatch mode")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--bf16-moments", action="store_true")
    ap.add_argument("--ssd-chunked", action="store_true")
    args = ap.parse_args(argv)
    archs = sorted(registry()) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["16x16"], "multi": ["2x16x16"],
              "both": list(MESHES)}[args.mesh]
    levers = Levers(remat=args.remat, microbatches=args.microbatches,
                    serve_tp_only=args.serve_tp_only,
                    moe_constrained=args.moe_constrained,
                    kv_quant=args.kv_quant, bf16_moments=args.bf16_moments,
                    ssd_chunked=args.ssd_chunked)
    bw = cost_model.calibrate(args.device).hbm_bw
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    records = run(archs, shapes, meshes, bw, args.out, verbose=True,
                  levers=levers,
                  variant=args.variant, skip_existing=args.skip_existing)
    failures = sum(r["status"] == "failed" for r in records)
    print(f"[dryrun] done: {len(records)} cells, {failures} failures, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
