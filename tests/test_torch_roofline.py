"""The roofline tools (``roofline/op_cost.py``, ``roofline/analysis.py``),
twins of ``tests/test_roofline.py``: counted flops scale with a Python
loop's trip count and multiply through nested loops, a plain matmul gives
2·m·n·k as the reference's ``analyze_hlo`` does on the same shapes,
``model_flops`` equals the reference on all 40 cells, and collective
bytes are what the port's collectives record (the compressed all-reduce's
wire sizes).  torch compiles no HLO (ROADMAP C40): flops are counted per
op as they run."""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import get_config, registry
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.distributed import ShardMesh
from repro_torch.launch.mesh import (HBM_BW_DATA_SHEET, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.optim.compress import compressed_psum
from repro_torch.roofline import analysis, op_cost


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("layers", [2, 8, 24])
def test_loop_flops_scale_with_trip_count(layers):
    def f(w, x):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x.sum()

    c = op_cost.analyze_fn(f, _meta(layers, 128, 128), _meta(4, 128))
    assert c.flops == layers * 2 * 4 * 128 * 128


def test_nested_loops_multiply():
    def f(w, x):
        for _ in range(3):
            for i in range(w.shape[0]):
                x = x @ w[i]
        return x.sum()

    c = op_cost.analyze_fn(f, _meta(5, 64, 64), _meta(2, 64))
    assert c.flops == 3 * 5 * 2 * 2 * 64 * 64


def test_plain_matmul_flops_equal_the_reference_hlo_count():
    import jax
    import jax.numpy as jnp
    from repro.roofline.hlo_cost import analyze_hlo
    a = jax.ShapeDtypeStruct((32, 48), jnp.float32)
    b = jax.ShapeDtypeStruct((48, 16), jnp.float32)
    ref = analyze_hlo(jax.jit(jnp.dot).lower(a, b).compile().as_text())
    c = op_cost.analyze_fn(torch.matmul, torch.ones(32, 48),
                           torch.ones(48, 16))
    assert c.flops == 2 * 32 * 48 * 16 == ref.flops
    # inputs and output once each
    assert c.bytes == 4 * (32 * 48 + 48 * 16 + 32 * 16)
    assert c.collective_bytes == 0


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", sorted(registry()))
def test_model_flops_equal_the_reference(arch, shape):
    from repro.configs.base import get_config as jget
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.roofline.analysis import model_flops as ref
    assert analysis.model_flops(get_config(arch), SHAPES[shape]) == ref(
        jget(arch), JSHAPES[shape])


def test_model_flops_formula():
    cfg = get_config("qwen3-8b")
    n = cfg.param_count()
    assert abs(analysis.model_flops(cfg, SHAPES["train_4k"])
               - 6 * n * 4096 * 256) / (6 * n * 4096 * 256) < 1e-6
    moe = get_config("qwen3-moe-235b-a22b")
    assert moe.active_param_count() < 0.15 * moe.param_count()
    assert 1.8e11 < moe.param_count() < 2.6e11
    assert 1.6e10 < moe.active_param_count() < 2.8e10


@pytest.mark.parametrize("mode,width", [("float32", 4), ("bfloat16", 2),
                                        ("int8", 1)])
def test_collective_bytes_are_the_wire_sizes(mode, width):
    trees = [{"a": torch.ones(64), "b": torch.ones(3, 5)} for _ in range(4)]
    c = op_cost.analyze_fn(compressed_psum, trees, ShardMesh(4, "cpu"),
                           mode)
    stats = c.collectives["all-reduce"]
    scales = 2 if mode == "int8" else 0      # one float32 amax per leaf
    assert stats["count"] == 2 + scales
    assert stats["bytes"] == 79 * width + 4 * scales == c.collective_bytes
    assert c.flops == 0
    assert all(v["count"] == 0 for k, v in c.collectives.items()
               if k != "all-reduce")


def test_roofline_terms_use_the_cards_constants():
    cfg = get_config("qwen1.5-0.5b")
    costs = op_cost.Costs(flops=1e12, bytes=6.7e9, collective_bytes=4.5e8)
    r = analysis.analyze("qwen1.5-0.5b", SHAPES["train_4k"], "1", 1, costs,
                         cfg)
    assert r.compute_s == 1e12 / PEAK_FLOPS_BF16
    assert r.memory_s == 6.7e9 / HBM_BW_DATA_SHEET
    assert r.collective_s == 4.5e8 / NVLINK_BW
    assert r.bottleneck == "memory"
    assert r.useful_ratio == analysis.model_flops(cfg, SHAPES["train_4k"]) \
        / 1e12
    slow = analysis.analyze("qwen1.5-0.5b", SHAPES["train_4k"], "1", 1,
                            dataclasses.replace(costs, collective_bytes=None),
                            cfg, hbm_bw=1e9)
    assert slow.collective_s is None and slow.bottleneck == "memory"
    assert set(r.to_dict()) >= {"arch", "shape", "mesh", "chips",
                                "hlo_flops", "hlo_bytes", "collective_bytes",
                                "model_flops", "compute_s", "memory_s",
                                "collective_s", "bottleneck",
                                "useful_ratio", "collectives"}


def test_remat_recompute_shows_in_the_counted_step():
    """A train step of a small model: full remat counts the recomputed
    forward inside the call, so its flops exceed remat none's, and remat
    none counts about 6·N·T."""
    from repro_torch.data.pipeline import pipeline_for_model
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg, device="cpu")
    opt = AdamWConfig()
    state = init_train_state(model, opt)
    batch = pipeline_for_model(cfg, 2, 32, seed=0, device="cpu").batch_at(0)
    flops = {r: op_cost.analyze_fn(make_train_step(model, opt, remat=r),
                                   state, batch).flops
             for r in ("none", "full")}
    six_nt = 6 * cfg.active_param_count() * 2 * 32
    assert 0.9 < flops["none"] / six_nt < 1.5
    assert flops["full"] > flops["none"]


@pytest.mark.parametrize("acc", ["allreduce", "reduce_scatter", "halo"])
def test_mesh_products_record_their_combine(acc):
    """An emulated mesh product records what each shard would put on the
    wire: its n-row partial (allreduce), its n_pad-row padded partial
    (reduce_scatter), or h rows of x and h rows of y (halo)."""
    from repro_torch.core import csrc
    from repro_torch.core import distributed as D
    from repro_torch.core.plan import ExecutionPlan
    M = csrc.fem_band(512, 8, seed=1)
    plan = ExecutionPlan(path="segment", strategy="mesh", mesh_p=4,
                         accumulation=acc)
    prod = D.build_sharded_spmv(M, ShardMesh(4, "cpu"), plan=plan)
    c = op_cost.analyze_fn(prod, torch.ones(M.n, 3))
    kind, nbytes = {"allreduce": ("all-reduce", M.n * 12),
                    "reduce_scatter": ("reduce-scatter", prod.n_pad * 12),
                    "halo": ("send-recv", 2 * prod.h * 12)}[acc]
    assert c.collectives[kind]["bytes"] == nbytes == c.collective_bytes
