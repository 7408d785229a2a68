"""The shapes table (``configs/shapes.py``) against the JAX package's: the
four shapes, every (arch × shape) cell's support verdict, and every input
of ``input_specs`` — decode states included — with the reference's
``ShapeDtypeStruct`` shape and dtype, the port's on the ``meta`` device."""
import functools

import jax
import numpy as np
import pytest

from repro.configs import shapes as jshapes
from repro.configs.base import get_config as jget
from repro.models.sharding import _path_names
from repro_torch import tree
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.base import get_config, registry
from repro_torch.models.transformer import build_model

ARCHS = sorted(registry())


@functools.lru_cache(maxsize=None)
def _model(arch):
    return build_model(get_config(arch), device="meta")


def _ref_leaves(specs):
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    return {_path_names(p): (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in flat}


def _port_leaves(specs):
    out = {}
    for p, t in tree.flatten_with_paths(specs):
        assert t.device.type in ("meta", "cpu"), p
        out[p] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
    return out


def test_the_shapes_table_equals_the_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in tshapes.SHAPES.items():
        r = jshapes.SHAPES[name]
        assert (s.name, s.kind, s.seq, s.batch) == (r.name, r.kind, r.seq,
                                                    r.batch)


@pytest.mark.parametrize("shape", list(tshapes.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    assert tshapes.cell_supported(cfg, tshapes.SHAPES[shape]) == \
        jshapes.cell_supported(jcfg, jshapes.SHAPES[shape])
    want = _ref_leaves(jshapes.input_specs(jcfg, jshapes.SHAPES[shape]))
    got = _port_leaves(tshapes.input_specs(cfg, tshapes.SHAPES[shape],
                                           _model(arch)))
    assert got == want
    # the tensors are meta stand-ins: no storage (the 0-d length is a host
    # scalar, as the decode path keeps it)
    for p, t in tree.flatten_with_paths(tshapes.input_specs(
            cfg, tshapes.SHAPES[shape], _model(arch))):
        assert t.device.type == "meta" or t.numel() == 1, p


def test_input_specs_builds_the_model_when_not_given():
    cfg = get_config("rwkv6-1.6b")
    a = tshapes.input_specs(cfg, tshapes.SHAPES["long_500k"])
    b = tshapes.input_specs(cfg, tshapes.SHAPES["long_500k"],
                            _model("rwkv6-1.6b"))
    assert _port_leaves(a) == _port_leaves(b)
    with pytest.raises(ValueError):
        tshapes.input_specs(cfg, tshapes.InputShape("x", "eval", 8, 1))


def test_long_context_flags():
    long = tshapes.SHAPES["long_500k"]
    supported = [a for a in ARCHS
                 if tshapes.cell_supported(get_config(a), long)[0]]
    assert sorted(supported) == ["rwkv6-1.6b", "zamba2-7b"]
