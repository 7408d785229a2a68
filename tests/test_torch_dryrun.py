"""The meta-device dry-run (``launch/dryrun.py``) against the JAX package's
placement: per (arch × shape × mesh) cell, the bytes one device holds of
the weights, the decode state and the inputs equal the same sums computed
from the reference's ``infer_param_specs`` / ``decode_state_specs`` and
``guard_spec`` on ``jax.eval_shape`` trees, and the skipped cells are the
reference's.  The reference's rules read only ``dict(mesh.shape)``, so
they get an object with that dict and no devices."""
import functools
import json
import math
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import shapes as jshapes
from repro.configs.base import get_config as jget
from repro.models import sharding as jsh
from repro.models.transformer import build_model as jbuild
from repro_torch.configs.base import registry
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, make_production_mesh

ARCHS = sorted(registry())


def _jmesh(mesh):
    return types.SimpleNamespace(shape=mesh.shape,
                                 axis_names=mesh.axis_names)


def _ref_bytes(sds_tree, spec_tree, mesh):
    """Σ leaf bytes / the mesh axes its guarded spec shards it over."""
    sizes = mesh.shape
    leaves = jax.tree_util.tree_leaves(sds_tree)
    specs = jax.tree_util.tree_leaves(spec_tree,
                                      is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for sds, spec in zip(leaves, specs, strict=True):
        split = 1
        for e in jsh.guard_spec(spec, sds.shape, _jmesh(mesh)):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                split *= sizes[a]
        total += math.prod(sds.shape) * np.dtype(sds.dtype).itemsize // split
    return total


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = jbuild(jget(arch))
    return model, jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _built(arch):
    return dryrun._Arch(arch)


@pytest.mark.parametrize("mesh_name", list(dryrun.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes_equal_the_references_placement(arch, mesh_name):
    mesh = make_production_mesh(multi_pod=dryrun.MESHES[mesh_name])
    jm, params = _ref_params(arch)
    pspecs = jsh.infer_param_specs(params, _jmesh(mesh))
    want_params = _ref_bytes(params, pspecs, mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    for shape_name, shape in jshapes.SHAPES.items():
        # the bytes need no trace: one cell per arch and mesh is traced
        # (decode, the quickest), the rest leave the compiled half null
        traced = shape_name == "decode_32k"
        rec = dryrun.lower_cell(arch, shape_name, mesh, mesh_name,
                                built=_built(arch), trace=traced)
        ok, why = jshapes.cell_supported(jm.cfg, shape)
        if not ok:
            assert rec == {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "skipped",
                           "reason": why}
            continue
        got = rec["per_device_bytes"]
        assert rec["status"] == "ok" and rec["chips"] == mesh.size
        assert got["params"] == want_params, shape_name
        specs = jshapes.input_specs(jm.cfg, shape)
        inputs = {k: v for k, v in specs.items() if k != "state"}
        assert got["inputs"] == _ref_bytes(
            inputs, {k: JP(batch_axes) for k in inputs}, mesh)
        if shape.kind == "train":
            assert got["moments"] == 2 * sum(
                v * 4 // np.dtype(s.dtype).itemsize for v, s in zip(
                    _leaf_bytes(params, pspecs, mesh),
                    jax.tree_util.tree_leaves(params)))
        else:
            assert got["serve_params"] >= got["params"]
        if shape.kind == "decode":
            sspecs = jm.decode_state_specs(
                batch_axes=batch_axes, model_size=mesh.shape["model"])
            assert got["decode_state"] == _ref_bytes(specs["state"], sspecs,
                                                     mesh)
        assert rec["memory"]["argument_size_in_bytes"] == sum(
            v for k, v in got.items() if k != "serve_params")
        assert rec["roofline"]["model_flops"] > 0
        if traced:
            assert rec["cost"]["flops"] > 0
            assert rec["cost"]["bytes accessed"] > 0
            assert rec["memory"]["temp_size_in_bytes"] > 0
            assert rec["memory"]["output_size_in_bytes"] > 0
            assert rec["trace"]["per_device_method"]
        else:
            assert rec["cost"] == {"flops": None, "bytes accessed": None}
            assert rec["roofline"]["hlo_flops"] is None
            assert rec["roofline"]["bottleneck"] is None
        assert rec["lower_s"] is None and rec["compile_s"] is None


def _leaf_bytes(sds_tree, spec_tree, mesh):
    specs = jax.tree_util.tree_leaves(spec_tree,
                                      is_leaf=lambda x: isinstance(x, JP))
    return [_ref_bytes(s, p, mesh) for s, p in zip(
        jax.tree_util.tree_leaves(sds_tree), specs, strict=True)]


def test_one_device_train_cell_holds_the_whole_state():
    """A 1 x 1 mesh shards nothing: qwen1.5-0.5b's weights (bf16) and its
    float32 AdamW moments whole — what the train phase measures on the
    card."""
    rec = dryrun.lower_cell("qwen1.5-0.5b", "train_4k",
                            MeshShape(("data", "model"), (1, 1)), "1x1")
    built = _built("qwen1.5-0.5b")
    weights = sum(t.numel() * t.element_size()
                  for t in built.model.state_dict().values())
    n = sum(t.numel() for t in built.model.state_dict().values())
    got = rec["per_device_bytes"]
    assert got["params"] == weights and got["moments"] == 8 * n
    assert n == 463_987_712
    assert got["inputs"] == 2 * 256 * 4096 * 4


def test_the_cli_writes_every_cell(tmp_path):
    assert dryrun.main(["--arch", "qwen1.5-0.5b,zamba2-7b", "--device",
                        "cpu", "--out", str(tmp_path)]) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 2 * 4 * 2
    recs = [json.loads((tmp_path / f).read_text()) for f in files]
    assert {r["status"] for r in recs} == {"ok", "skipped"}
    assert sum(r["status"] == "skipped" for r in recs) == 2   # qwen × 500k


def test_the_cli_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k"])
