"""Sharding rules (``models/sharding.py``) and ``decode_state_specs``
against the JAX package's, at full size: every leaf of all ten archs'
params trees (the port's built on ``meta`` in the stacked layout, the
reference's from ``jax.eval_shape(model.init)``) gets the same spec on
the (16, 16), (2, 16, 16) and (4, 2) meshes; the decode-state specs and
their guards on the decode state's shapes are equal too.  The reference
reads only ``dict(mesh.shape)``, so it gets an object with that dict and
no devices.  ``materialize`` places tensors on a gloo ``DeviceMesh`` of 1
and 2 ranks."""
import functools
import os
import socket
import subprocess
import sys
import textwrap
import types

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as jget
from repro.models import sharding as jsh
from repro.models.transformer import build_model as jbuild
from repro_torch import convert, tree
from repro_torch.configs.base import get_config, registry
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import sharding as tsh
from repro_torch.models.transformer import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(registry())
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "4x2": make_test_mesh(8, 2)}


def _jmesh(mesh):
    """What the reference's rules read of a mesh: its shape dict."""
    return types.SimpleNamespace(shape=mesh.shape,
                                 axis_names=mesh.axis_names)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    model = jbuild(jget(arch))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port(arch):
    model = build_model(get_config(arch), device="meta")
    return model, convert.lm_params_tree(model.state_dict())


def _ref_leaves(spec_tree):
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP) or x is None)[0]
    return {jsh._path_names(p): (None if s is None else tuple(s))
            for p, s in flat}


def _port_leaves(spec_tree):
    return {p: tuple(s) for p, s in tree.flatten_with_paths(spec_tree)}


def test_production_meshes_have_the_reference_shapes():
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}
    assert MESHES["4x2"].shape == {"data": 4, "model": 2}
    assert [m.size for m in MESHES.values()] == [256, 512, 8]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference_on_every_leaf(arch, mesh):
    ref = _ref_params(arch)
    _, params = _port(arch)
    want = _ref_leaves(jsh.infer_param_specs(ref, _jmesh(MESHES[mesh])))
    got = _port_leaves(tsh.infer_param_specs(params, MESHES[mesh]))
    assert got == want
    shapes = {jsh._path_names(p): tuple(s.shape) for p, s in
              jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert {p: tuple(t.shape) for p, t in
            tree.flatten_with_paths(params)} == shapes


BATCH = {"16x16": (("data",), 16), "2x16x16": (("pod", "data"), 16),
         "4x2": (("data",), 2)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_and_their_guards_equal_the_reference(arch,
                                                                 mesh):
    batch_axes, model_size = BATCH[mesh]
    jm = jbuild(jget(arch))
    model, _ = _port(arch)
    want = jm.decode_state_specs(batch_axes=batch_axes,
                                 model_size=model_size)
    got = model.decode_state_specs(batch_axes=batch_axes,
                                   model_size=model_size)
    assert _port_leaves(got) == {k: v for k, v in _ref_leaves(want).items()
                                 if v is not None}
    # guarded on the decode state of a 32 x 4,096 batch
    state = jax.eval_shape(lambda: jm.init_decode_state(32, 4096))
    ref_sh = jax.tree_util.tree_flatten_with_path(state)[0]
    ref_specs = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, JP))
    jmesh = _jmesh(MESHES[mesh])
    guarded_want = {jsh._path_names(p): tuple(jsh.guard_spec(s, sds.shape,
                                                             jmesh))
                    for (p, sds), s in zip(ref_sh, ref_specs, strict=True)}
    tstate = model.init_decode_state(32, 4096)
    guarded_got = {p: tuple(tsh.guard_spec(s, t.shape, MESHES[mesh]))
                   for (p, t), s in zip(tree.flatten_with_paths(tstate),
                                        tree.leaves(got), strict=True)}
    assert guarded_got == guarded_want


def test_granite_vocab_falls_back_to_replication():
    _, params = _port("granite-3-2b")
    assert params["embed"].shape[0] == 49155
    specs = tsh.infer_param_specs(params, MESHES["16x16"])
    assert specs["embed"] == tsh.P(None, "data")     # 49155 % 16 != 0
    ref = jsh.infer_param_specs(_ref_params("granite-3-2b"),
                                _jmesh(MESHES["16x16"]))
    assert tuple(ref["embed"]) == tuple(specs["embed"])
    # qwen3-8b's vocab divides: sharded over model
    _, qparams = _port("qwen3-8b")
    assert tsh.infer_param_specs(qparams, MESHES["16x16"])["embed"] == \
        tsh.P("model", "data")


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (32, 48)), ((("pod", "data"), None), (64, 8)),
    ((("pod", "data"), "model"), (6, 32)), (("model",), (30, 4)),
    ((), (3, 5)), ((None, ("data", "model")), (2, 512))])
def test_guard_spec_equals_the_reference(spec, shape):
    for mesh in MESHES.values():
        assert tuple(tsh.guard_spec(spec, shape, mesh)) == tuple(
            jsh.guard_spec(JP(*spec), shape, _jmesh(mesh)))


def test_constrain_is_the_identity_without_a_mesh():
    import torch
    x = torch.ones(8, 4)
    assert tsh.constrain(x, "data", None) is x
    assert tsh.constrain_tokens(x) is x and tsh.batch_axes() == ()
    with tsh.use_mesh(MESHES["2x16x16"]):
        assert tsh.batch_axes() == ("pod", "data")
        assert tsh.constrain_tokens(x) is x      # no DeviceMesh: unchanged
    assert tsh.batch_axes() == ()


RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import convert, tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import sharding as tsh
    from repro_torch.models.transformer import build_model
    model = build_model(get_config("qwen1.5-0.5b", reduced=True),
                        device="cpu")
    params = convert.lm_params_tree(model.state_dict())
    mesh = MeshShape(("data", "model"), (1, world))
    dm = mesh.device_mesh("cpu")
    specs = tsh.infer_param_specs(params, mesh)
    placed = tsh.materialize(specs, params, dm)
    sharded = 0
    for (path, t), d, s in zip(tree.flatten_with_paths(params),
                               tree.leaves(placed), tree.leaves(specs)):
        assert isinstance(d, DTensor), path
        assert d.placements == tsh.placements(s, t.shape, dm), path
        assert torch.equal(d.full_tensor(), t), path
        dim = next((i for i, e in enumerate(tsh.guard_spec(s, t.shape,
                                                           mesh))
                    if e == "model"), None)
        if dim is None:
            assert d.placements == (Replicate(), Replicate())
            assert torch.equal(d.to_local(), t)
        else:
            sharded += 1
            assert d.placements == (Replicate(), Shard(dim))
            assert torch.equal(d.to_local(), t.chunk(world, dim)[rank])
    assert (sharded > 0) == (world > 1), sharded
    # constrain redistributes a DTensor under the active DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    x = distribute_tensor(torch.arange(8.0 * world).reshape(4, 2 * world),
                          dm, [Replicate(), Replicate()])
    with tsh.use_mesh(dm):
        y = tsh.constrain(x, ("data",), "model")
    assert y.placements == ((Replicate(), Shard(1)) if world > 1
                            else (Replicate(), Replicate())), y.placements
    assert torch.equal(y.full_tensor(), x.full_tensor())
    dist.destroy_process_group()
    print("OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2])
def test_materialize_places_the_params_on_a_gloo_device_mesh(world):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(world), port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"OK {r}" in out, err[-3000:]
