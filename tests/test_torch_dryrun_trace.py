"""The dry-run's compiled half: the op tracer (``roofline/trace.py``), its
rollup over repeat counts and scan lengths, and the levers of
``launch/dryrun.py``.

  * the tracer on functions whose counts are known by hand;
  * the rollup (two copies per repeat count, the scans fitted alone)
    against one trace of the whole step, for the ten archs' reduced
    configs (deepened so the counts are extrapolated) x train, prefill
    and decode, on a (1, 1) and a (2, 2) mesh: flops and bytes accessed
    equal, the peak within 1 %; each scan against its stand-in;
  * the traced flops of a train step against the JAX package's compiled
    step, its dots rolled up by ``hlo_cost``'s while-loop trip counts;
  * each lever against the reference (bytes under its placement, the
    hierarchical MoE dispatch on the same inputs), the flags restored
    after every cell, the CLI's variant files and ``--skip-existing``."""
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import shapes as jshapes
from repro.configs.base import get_config as jget
from repro.models import moe as JO
from repro.models import sharding as jsh
from repro.models.transformer import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.roofline import hlo_cost
from repro.train.step import init_train_state as jinit
from repro.train.step import make_train_step as jstep
from repro_torch.configs.base import get_config, registry
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.roofline import trace

ARCHS = sorted(registry())
MESHES = {"1x1": MeshShape(("data", "model"), (1, 1)),
          "2x2": MeshShape(("data", "model"), (2, 2))}


def _strip_axis_ref():
    """The reference dry-run's ``_strip_axis``; its module sets
    ``XLA_FLAGS`` for 512 host devices on import, which is put back at
    once (jax reads it only when its backend starts)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdry._strip_axis


# ---------------------------------------------------------------------------
# The tracer on known functions
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_counts():
    a, b = _meta(8, 16), _meta(16, 32)
    tr = trace.trace_fn(lambda x, y: x @ y, a, b)
    assert tr.flops == 2 * 8 * 16 * 32
    assert tr.bytes_accessed == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    assert tr.peak_temp_bytes == tr.output_bytes == 4 * 8 * 32
    assert tr.argument_bytes == 4 * (8 * 16 + 16 * 32)
    assert tr.ops == 1


def test_a_loop_counts_every_iteration_and_frees_as_it_goes():
    def loop(x, n=5):
        for _ in range(n):
            x = x + 1
        return x

    x = _meta(1000)
    tr = trace.trace_fn(loop, x)
    assert tr.ops == 5 and tr.flops == 0
    assert tr.bytes_accessed == 5 * 2 * 4000
    # the new value and the one it replaces are live together
    assert tr.peak_temp_bytes == 2 * 4000
    assert tr.output_bytes == 4000


def test_known_allocations_and_frees():
    def fn():
        a = torch.empty(100, dtype=torch.uint8, device="meta")
        b = torch.empty(200, dtype=torch.uint8, device="meta")
        del a
        c = torch.empty(50, dtype=torch.uint8, device="meta")
        d = torch.empty(400, dtype=torch.uint8, device="meta")
        del d
        return b, c

    tr = trace.trace_fn(fn)
    assert tr.peak_temp_bytes == 200 + 50 + 400
    assert tr.output_bytes == 250
    assert tr.argument_bytes == 0


def test_views_and_weights_are_no_temporaries():
    """A view of a tensor the call did not make (a module weight, an
    argument) is no new storage; an in-place write makes none either."""
    w = _meta(64, 64)

    def fn(x):
        y = x @ w.T                  # w.T: a view of a weight
        x.add_(1)                    # in place on the argument
        return y[:, :8]              # a view of y: y's storage

    tr = trace.trace_fn(fn, _meta(4, 64))
    assert tr.peak_temp_bytes == tr.output_bytes == 4 * 4 * 64


def test_bincount_on_meta():
    idx = torch.empty(100, dtype=torch.int64, device="meta")
    got = {}

    def fn(i):
        got["out"] = torch.bincount(i, minlength=8)
        return got["out"]

    tr = trace.trace_fn(fn, idx)
    assert got["out"].shape == (8,) and got["out"].dtype == torch.int64
    assert tr.output_bytes == 64


def test_composites_under_inference_mode_count_their_matmuls():
    """Under inference mode matmul / einsum reach the tracer whole: it
    decomposes them, so prefill and decode count their matmuls."""
    a, b = _meta(3, 8, 16), _meta(16, 32)
    with torch.inference_mode():
        tr = trace.trace_fn(lambda x, y: torch.einsum("bsk,kn->bsn", x, y),
                            a, b)
    assert tr.flops == 2 * 3 * 8 * 16 * 32


def test_the_meta_cache_changes_no_count():
    cfg = _deeper(get_config("qwen3-8b", reduced=True))
    lev = dryrun.Levers()
    trace._META.clear()
    cold = dryrun.trace_cell(cfg, "train", 4, 32, lev, 2, rollup=False)
    warm = dryrun.trace_cell(cfg, "train", 4, 32, lev, 2, rollup=False)
    for f in ("flops", "bytes_accessed", "peak_temp_bytes", "output_bytes",
              "ops"):
        assert getattr(cold, f) == getattr(warm, f), f


# ---------------------------------------------------------------------------
# The rollup against whole traces
# ---------------------------------------------------------------------------

def _deeper(cfg, units=4):
    """The reduced config with ``units`` repeated units, so the rollup
    (traced at 2 and 3) extrapolates."""
    return dryrun._with_units(cfg, units)


# batch, seq, microbatches per kind (the batch is the whole mesh's)
KINDS = {"train": (8, 32, 4), "prefill": (4, 32, 1), "decode": (4, 32, 1)}


@functools.lru_cache(maxsize=None)
def _traces(arch, kind, mesh_name, remat="full"):
    cfg = _deeper(get_config(arch, reduced=True))
    mesh = MESHES[mesh_name]
    b, s, mb = KINDS[kind]
    local = dryrun.local_batch(InputShape(kind, kind, s, b), mesh)
    lev = dryrun.Levers(remat=remat)
    return (dryrun.trace_cell(cfg, kind, local, s, lev, mb, rollup=False),
            dryrun.trace_cell(cfg, kind, local, s, lev, mb, rollup=True))


def _assert_rollup(whole, rolled):
    assert rolled.flops == pytest.approx(whole.flops, rel=1e-12, abs=0)
    assert rolled.bytes_accessed == pytest.approx(whole.bytes_accessed,
                                                  rel=1e-12, abs=0)
    assert rolled.output_bytes == pytest.approx(whole.output_bytes,
                                                rel=1e-12, abs=0)
    assert rolled.peak_temp_bytes == pytest.approx(whole.peak_temp_bytes,
                                                   rel=0.01)
    assert rolled.traces > 1 and whole.traces == 1


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_rollup_equals_the_whole_trace(arch, kind, mesh_name):
    whole, rolled = _traces(arch, kind, mesh_name)
    _assert_rollup(whole, rolled)
    assert whole.flops > 0 and whole.peak_temp_bytes > 0


@pytest.mark.parametrize("remat", ["none", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b"])
def test_rollup_under_other_remat_policies(arch, remat):
    whole, rolled = _traces(arch, "train", "1x1", remat)
    _assert_rollup(whole, rolled)


def _scan_args(name, t, grad):
    b, h, p, n = 2, 4, 32, 16
    if name.startswith("_ssd"):
        shapes = [(b, t, h, p), (b, t, n), (b, t, n), (b, t, h), (h,),
                  (b, h, p, n)]
    else:
        shapes = [(b, t, h, n)] * 4 + [(h, n), (b, h, n, n)]
    return [torch.empty(s, device="meta").requires_grad_(grad and i < 5)
            for i, s in enumerate(shapes)]


def _scan_run(name, t, grad, rolled):
    mod = mamba2 if name.startswith("_ssd") else rwkv6
    args = _scan_args(name, t, grad)

    def call():
        with torch.set_grad_enabled(grad):
            # the inputs stay referenced through the call, as the models
            # hold theirs (the zero or decode state, the float streams)
            xs = [a * 1 for a in args]
            y, _ = getattr(mod, name)(*xs)
            z = (y * 2).sum()
            if grad:
                z.backward()
        return z

    with (trace.rolled_scans(dryrun._scans()) if rolled
          else contextlib.nullcontext()):
        return trace.trace_fn(call)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("name,t", [("_ssd_recurrent", 160),
                                    ("_wkv_recurrent", 160),
                                    ("_ssd_chunked", 16 * 160),
                                    ("_wkv_chunked", 16 * 160)])
def test_each_scan_against_its_stand_in(name, t, grad):
    """Past four times its shortest fit the stand-in's counts are fitted,
    not measured: flops and bytes equal the scan's, the peak within 1 %."""
    whole = _scan_run(name, t, grad, rolled=False)
    trace._FITS.clear()
    rolled = _scan_run(name, t, grad, rolled=True)
    fits = list(trace._FITS.values())
    assert len(fits) == 1 and all(c[1] is not None
                                  for c in fits[0]._coef.values())
    assert rolled.flops == pytest.approx(whole.flops, rel=1e-12)
    assert rolled.bytes_accessed == pytest.approx(whole.bytes_accessed,
                                                  rel=1e-12)
    assert rolled.peak_temp_bytes == pytest.approx(whole.peak_temp_bytes,
                                                   rel=0.01)


@pytest.mark.parametrize("arch,remat", [
    (a, r) for a in ("qwen1.5-0.5b", "deepseek-v2-lite-16b", "rwkv6-1.6b")
    for r in ("none", "full", "dots")] + [("zamba2-7b", "none")])
def test_traced_flops_equal_the_real_steps_count(arch, remat):
    """The rolled-up trace against ``FlopCounterMode`` around the real
    step and prefill on the CPU (what ``chip_smoke.py``'s ``dist_trace``
    holds on the card): equal."""
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.op_cost import analyze_fn
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = _deeper(get_config(arch, reduced=True))
    b, s = 2, 80                    # past the scans' shortest fit
    opt = AdamWConfig(lr_peak=3e-4, warmup_steps=1, total_steps=100)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(28))
    g = torch.Generator().manual_seed(29)
    batch = {k: torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32,
                              generator=g) for k in ("inputs", "targets")}
    real = analyze_fn(make_train_step(model, opt, remat=remat),
                      init_train_state(model, opt), batch).flops
    traced = dryrun.trace_cell(cfg, "train", b, s,
                               dryrun.Levers(remat=remat), 1, opt_cfg=opt)
    assert traced.flops == real
    if remat == "none":
        with torch.inference_mode():
            real = analyze_fn(model.prefill, batch["inputs"], s).flops
        assert dryrun.trace_cell(cfg, "prefill", b, s, dryrun.Levers(),
                                 1).flops == real


# ---------------------------------------------------------------------------
# Flops against the reference's compiled step
# ---------------------------------------------------------------------------

def _dot_flops(text: str) -> float:
    """Dot flops of compiled HLO, while-loop bodies times their trip
    counts (``hlo_cost.parse_hlo`` / ``_trip_count`` / ``_dot_flops``)."""
    comps = hlo_cost.parse_hlo(text)
    entry = next(c for c in comps.values() if c.is_entry)
    memo = {}

    def cost(c):
        if c.name not in memo:
            f = 0.0
            for ins in c.instrs:
                if ins.op == "dot":
                    f += hlo_cost._dot_flops(ins, c.shapes)
                elif ins.op == "while":
                    body = re.search(r"body=%?([\w\.\-]+)", ins.attrs)
                    cond = re.search(r"condition=%?([\w\.\-]+)", ins.attrs)
                    f += hlo_cost._trip_count(comps[cond.group(1)]) * cost(
                        comps[body.group(1)])
                else:
                    for m in re.finditer(
                            r"(?:to_apply|branch_computations=\{|calls=)%?"
                            r"([\w\.\-]+)", ins.attrs):
                        if m.group(1) in comps:
                            f += cost(comps[m.group(1)])
            memo[c.name] = f
        return memo[c.name]

    return cost(entry)


def _scan_readout_flops(cfg, b, s):
    """Flops of the recurrent scans' per-token read-out: one
    matrix-vector product a head and token (WKV6 ``r_t · S``, SSD
    ``h_t · C_t``).  XLA's algebraic simplifier rewrites these dots of
    one row into a multiply and a reduce, which a dot-only rollup does
    not count; the port runs them as ``bmm``."""
    if cfg.family == "ssm":
        n = cfg.d_model // cfg.n_heads
        return 2.0 * b * cfg.n_heads * n * n * s * cfg.n_layers
    if cfg.family == "hybrid":
        d_inner = cfg.ssm.d_inner or 2 * cfg.d_model
        return 2.0 * b * d_inner * cfg.ssm.d_state * s * cfg.n_layers
    return 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_equal_the_references_dots(arch):
    """Remat none, B 2 x S 32, one microbatch.  Dense and MoE archs:
    equal.  RWKV6 and the hybrid: equal once the scans' read-outs that
    XLA turns into multiply-reduce are added (rwkv6 1.0039, zamba2 1.0148
    without them)."""
    b, s = 2, 32
    jcfg = jget(arch, reduced=True)
    jm = jbuild(jcfg)
    opt = JAdamW()
    state = jax.eval_shape(lambda: jinit(jm, opt, jax.random.PRNGKey(0)))
    if jcfg.input_mode == "tokens":
        inp = jax.ShapeDtypeStruct((b, s), jnp.int32)
    else:
        inp = jax.ShapeDtypeStruct((b, s, jcfg.d_model), jnp.bfloat16)
    batch = {"inputs": inp, "targets": jax.ShapeDtypeStruct((b, s),
                                                            jnp.int32)}
    text = jax.jit(jstep(jm, opt, microbatches=1, remat="none")).lower(
        state, batch).compile().as_text()
    ref = _dot_flops(text)
    cfg = get_config(arch, reduced=True)
    got = dryrun.trace_cell(cfg, "train", b, s, dryrun.Levers(remat="none"),
                            1, rollup=False).flops
    readout = _scan_readout_flops(cfg, b, s)
    assert got == ref + readout
    if readout:
        assert got / ref < 1.02
    if cfg.family == "ssm":
        assert got / ref < 1.01


# ---------------------------------------------------------------------------
# The levers against the reference
# ---------------------------------------------------------------------------

def _jmesh(mesh):
    return types.SimpleNamespace(shape=mesh.shape,
                                 axis_names=mesh.axis_names)


def _ref_bytes(sds_tree, spec_tree, mesh):
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
def _ref_model(arch, kv_quant=False):
    cfg = jget(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg, jbuild(cfg)


@functools.lru_cache(maxsize=None)
def _built(arch, kv_quant=False):
    return dryrun._Arch(arch, kv_quant)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moments_bytes_equal_the_references(arch):
    mesh = make_production_mesh(multi_pod=False)
    _, jm = _ref_model(arch)
    opt = JAdamW(moment_dtype="bfloat16")
    state = jax.eval_shape(lambda: jinit(jm, opt, jax.random.PRNGKey(0)))
    pspecs = jsh.infer_param_specs(state.params, _jmesh(mesh))
    want = (_ref_bytes(state.opt.m, pspecs, mesh)
            + _ref_bytes(state.opt.v, pspecs, mesh))
    rec = dryrun.lower_cell(arch, "train_4k", mesh, built=_built(arch),
                            levers=dryrun.Levers(bf16_moments=True),
                            trace=False)
    assert rec["per_device_bytes"]["moments"] == want


def test_bf16_moments_halve_the_one_device_cell():
    one = MeshShape(("data", "model"), (1, 1))
    f32, bf16 = (dryrun.lower_cell(
        "qwen1.5-0.5b", "train_4k", one, "1x1", built=_built("qwen1.5-0.5b"),
        levers=dryrun.Levers(bf16_moments=b), trace=False)
        ["per_device_bytes"]["moments"] for b in (False, True))
    assert (f32, bf16) == (3_711_901_696, 1_855_950_848)


@pytest.mark.parametrize("mesh_name", list(dryrun.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_kv_quant_decode_state_equals_the_references(arch, mesh_name):
    mesh = make_production_mesh(multi_pod=dryrun.MESHES[mesh_name])
    jcfg, jm = _ref_model(arch, kv_quant=True)
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    shape = jshapes.SHAPES["decode_32k"]
    specs = jshapes.input_specs(jcfg, shape)
    sspecs = jm.decode_state_specs(batch_axes=batch_axes,
                                   model_size=mesh.shape["model"])
    want = _ref_bytes(specs["state"], sspecs, mesh)
    rec = dryrun.lower_cell(arch, "decode_32k", mesh, mesh_name,
                            built=_built(arch, True),
                            levers=dryrun.Levers(kv_quant=True), trace=False)
    assert rec["per_device_bytes"]["decode_state"] == want
    plain = dryrun.lower_cell(arch, "decode_32k", mesh, mesh_name,
                              built=_built(arch), trace=False)
    if jcfg.family in ("dense", "audio", "vlm") or (
            jcfg.family == "moe" and jcfg.mla is None):
        # int8 values and bf16 scales: a little over half
        ratio = want / plain["per_device_bytes"]["decode_state"]
        assert 0.5 < ratio < 0.6


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tp_only_params_equal_the_references_strip(arch):
    strip = _strip_axis_ref()
    mesh = make_production_mesh(multi_pod=True)
    _, jm = _ref_model(arch)
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    specs = strip(jsh.infer_param_specs(params, _jmesh(mesh)), "data")
    want = _ref_bytes(params, specs, mesh)
    for shape_name in ("prefill_32k", "decode_32k"):
        rec = dryrun.lower_cell(arch, shape_name, mesh, "2x16x16",
                                built=_built(arch),
                                levers=dryrun.Levers(serve_tp_only=True),
                                trace=False)
        got = rec["per_device_bytes"]
        assert got["params"] == want and "serve_params" not in got
        assert rec["memory"]["argument_size_in_bytes"] == sum(got.values())
    # a train cell keeps the training placement
    train = [dryrun.lower_cell(arch, "train_4k", mesh, "2x16x16",
                               built=_built(arch),
                               levers=dryrun.Levers(serve_tp_only=tp),
                               trace=False)["per_device_bytes"]
             for tp in (False, True)]
    assert train[0] == train[1]


def test_hierarchical_switch_equals_the_references_hierarchical():
    """``moe.CONSTRAIN_DISPATCH = "hierarchical"`` routes ``moe_forward``
    through the two-stage dispatch: float32, 1e-5 of the reference's
    ``moe_forward_hierarchical`` on the same inputs; "constrain" runs the
    global dispatch unchanged."""
    e, k, d, ff = 8, 2, 32, 48
    rng = np.random.default_rng(28)
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "w_gate": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, ff, d)) / np.sqrt(ff)}
    w = {n: a.astype(np.float32) for n, a in w.items()}
    x = rng.standard_normal((6, 4, d)).astype(np.float32)
    pj = {n: jnp.asarray(a) for n, a in w.items()}
    from repro_torch.models.layers import Params
    pt = Params(**{n: torch.from_numpy(a.copy()) for n, a in w.items()})
    kw = dict(num_experts=e, top_k=k, capacity_factor=1.0)
    want, waux = jax.jit(functools.partial(JO.moe_forward_hierarchical,
                                           **kw))(pj, jnp.asarray(x))
    glob, _ = moe.moe_forward(pt, torch.from_numpy(x.copy()), **kw)
    saved = moe.CONSTRAIN_DISPATCH
    try:
        moe.CONSTRAIN_DISPATCH = "hierarchical"
        got, aux = moe.moe_forward(pt, torch.from_numpy(x.copy()), **kw)
        moe.CONSTRAIN_DISPATCH = "constrain"
        same, _ = moe.moe_forward(pt, torch.from_numpy(x.copy()), **kw)
    finally:
        moe.CONSTRAIN_DISPATCH = saved
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max())
    assert float(aux["dropped_fraction"]) == pytest.approx(
        float(waux["dropped_fraction"]), abs=1e-7)
    assert float(aux["dropped_fraction"]) > 0     # capacity binds per group
    assert torch.equal(same, glob)
    assert not torch.equal(got, glob)


# ---------------------------------------------------------------------------
# Housekeeping
# ---------------------------------------------------------------------------

def _flags():
    return (moe.CONSTRAIN_DISPATCH, mamba2.CHUNKED_SSD, rwkv6.CHUNKED_WKV)


def test_every_flag_is_restored_after_its_cell(monkeypatch):
    before = _flags()
    lev = dryrun.Levers(moe_constrained="hierarchical", ssd_chunked=True,
                        remat="none", microbatches=2)
    seen = []
    real = dryrun.trace_cell

    def spy(*a, **kw):
        seen.append(_flags())
        out = real(*a, **kw)
        seen.append(_flags())
        return out

    monkeypatch.setattr(dryrun, "trace_cell", spy)
    recs = dryrun.run(["zamba2-7b"], ["decode_32k"], ["16x16"],
                      hbm_bw=3.35e12, levers=lev)
    assert recs[0]["status"] == "ok" and _flags() == before
    assert recs[0]["levers"]["moe_constrained"] == "hierarchical"
    # inside the cell the switches are the lever's
    with dryrun.levers_applied(lev):
        assert _flags() == ("hierarchical", True, True)
    assert _flags() == before

    def boom(*a, **kw):
        with dryrun.levers_applied(lev):
            raise RuntimeError("a cell that fails")

    monkeypatch.setattr(dryrun, "trace_cell", boom)
    recs = dryrun.run(["qwen1.5-0.5b"], ["decode_32k"], ["16x16"],
                      hbm_bw=3.35e12, levers=lev)
    assert recs[0]["status"] == "failed" and _flags() == before


def test_the_cli_writes_variant_files_and_skips_existing(tmp_path):
    args = ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k,long_500k",
            "--mesh", "single", "--device", "cpu", "--out", str(tmp_path),
            "--variant", "kvq", "--kv-quant"]
    assert dryrun.main(args) == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["qwen1.5-0.5b__decode_32k__16x16__kvq.json",
                     "qwen1.5-0.5b__long_500k__16x16__kvq.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["variant"] == "kvq" and rec["levers"]["kv_quant"] is True
    assert rec["cost"]["flops"] > 0 and "trace" in rec
    # --skip-existing: an existing file is left as it is
    (tmp_path / files[0]).write_text('{"untouched": true}')
    assert dryrun.main(args + ["--skip-existing"]) == 0
    assert json.loads((tmp_path / files[0]).read_text()) == {
        "untouched": True}
    assert dryrun.main(args) == 0
    assert json.loads((tmp_path / files[0]).read_text())["variant"] == "kvq"


def test_a_traced_cell_fills_the_compiled_half():
    mesh = make_production_mesh(multi_pod=False)
    rec = dryrun.lower_cell("qwen3-8b", "decode_32k", mesh,
                            built=_built("qwen3-8b"))
    tr = rec["trace"]
    assert rec["cost"]["flops"] == tr["flops"] / mesh.shape["model"]
    assert rec["cost"]["bytes accessed"] == \
        tr["bytes_accessed"] / mesh.shape["model"]
    assert rec["memory"]["temp_size_in_bytes"] == int(tr["peak_temp_bytes"])
    assert rec["memory"]["output_size_in_bytes"] == int(tr["output_bytes"])
    assert rec["roofline"]["hlo_flops"] == rec["cost"]["flops"]
    assert rec["roofline"]["hlo_bytes"] == rec["cost"]["bytes accessed"]
    assert rec["roofline"]["collective_bytes"] is None
    assert tr["batch"] == 128 // 16 and "per_device_method" in tr
    assert rec["lower_s"] is None and rec["compile_s"] is None
