"""The port's optimizer and train step against the JAX package's, on the
same inputs from a numpy seed: one AdamW ``update`` from the same
gradients and state (params and moments within 1e-6 of the reference's,
in float32), ``lr_at`` and ``global_norm``, ``ef_accumulate``,
``make_train_step`` against the reference's jitted step on one batch of
the reduced qwen1.5-0.5b in float32 (microbatches 1 and 4, float32 and
bfloat16 accumulation, remat none / full / dots), and the params tree
against the reference's ``model.init`` tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models.transformer import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim.compress import ef_accumulate as jef
from repro.train import step as jstep
from repro_torch import convert, tree
from repro_torch.configs.base import get_config as tget
from repro_torch.models.transformer import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.compress import ef_accumulate as tef
from repro_torch.train import step as tstep

from test_torch_parity_helpers import lm_inputs, lm_pair, np32, rel_err

OPT = dict(lr_peak=1e-3, warmup_steps=5, total_steps=50)


def _tree_np(rng, dtype=np.float32):
    """A small params-like tree: 1-D, 2-D and stacked 3-D leaves."""
    return {"final_norm": (1 + 0.1 * rng.standard_normal(16)).astype(dtype),
            "embed": rng.standard_normal((32, 16)).astype(dtype),
            "layers": {"ln1": rng.standard_normal((3, 16)).astype(dtype),
                       "attn": {"wq": rng.standard_normal(
                           (3, 16, 8)).astype(dtype)}}}


def _to_torch(t):
    return tree.map(lambda a: torch.from_numpy(np.asarray(a)), t)


def _assert_trees_close(got, want, bar, what):
    for (path, g), w in zip(tree.flatten_with_paths(got),
                            jax.tree.leaves(want)):
        assert rel_err(g, np.asarray(w)) < bar, (what, path)


@pytest.mark.parametrize("step", [0, 3, 7])
@pytest.mark.parametrize("clip_norm", [1.0, 100.0])   # clipped, not clipped
def test_one_adamw_update_matches(step, clip_norm):
    rng = np.random.default_rng(step)
    params, grads = _tree_np(rng), _tree_np(rng)
    m, v = _tree_np(rng), jax.tree.map(np.abs, _tree_np(rng))
    jc = jadamw.AdamWConfig(clip_norm=clip_norm, **OPT)
    tc = tadamw.AdamWConfig(clip_norm=clip_norm, **OPT)
    jp, js, jmet = jadamw.update(
        jc, jadamw.AdamWState(step=jnp.asarray(step, jnp.int32), m=m, v=v),
        params, grads)
    tp, ts, tmet = tadamw.update(
        tc, tadamw.AdamWState(step=torch.tensor(step, dtype=torch.int32),
                              m=_to_torch(m), v=_to_torch(v)),
        _to_torch(params), _to_torch(grads))
    _assert_trees_close(tp, jp, 1e-6, "params")
    _assert_trees_close(ts.m, js.m, 1e-6, "m")
    _assert_trees_close(ts.v, js.v, 1e-6, "v")
    assert int(ts.step) == int(js.step) == step + 1
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        1e-6 * float(jmet["grad_norm"])
    assert tmet["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-7)


def test_update_writes_none_of_its_arguments():
    rng = np.random.default_rng(0)
    params, grads = _to_torch(_tree_np(rng)), _to_torch(_tree_np(rng))
    cfg = tadamw.AdamWConfig(**OPT)
    state = tadamw.init(cfg, params)
    args = {"params": params, "grads": grads, "state": state}
    before = [t.clone() for t in tree.leaves(args)]
    tadamw.update(cfg, state, params, grads)
    for a, b in zip(tree.leaves(args), before, strict=True):
        assert torch.equal(a, b)


def test_bf16_moments_and_params():
    """moment_dtype='bfloat16' and bf16 params: the port rounds the same
    float32 values the reference does (within one bf16 ulp where a value
    sits on a rounding boundary)."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                          _tree_np(rng))
    grads = _tree_np(rng)
    jc = jadamw.AdamWConfig(moment_dtype="bfloat16", **OPT)
    tc = tadamw.AdamWConfig(moment_dtype="bfloat16", **OPT)
    js0 = jadamw.init(jc, params)
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, params))
    ts0 = tadamw.init(tc, tparams)
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves(ts0.m))
    jp, js, _ = jadamw.update(jc, js0, params, grads)
    tp, ts, _ = tadamw.update(tc, ts0, tparams, _to_torch(grads))
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.bfloat16
            assert rel_err(g, w) <= 2.0 ** -8


def test_lr_schedule_matches_at_every_step():
    for cfg_kw in (dict(lr_peak=1e-3, warmup_steps=10, total_steps=100,
                        lr_min_ratio=0.1), OPT, dict(warmup_steps=0)):
        jc, tc = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
        for s in list(range(0, 120, 3)) + [9, 10, 11, 99]:
            assert tadamw.lr_at(tc, s) == pytest.approx(
                float(jadamw.lr_at(jc, s)), rel=1e-6, abs=1e-12), (cfg_kw, s)


def test_global_norm_matches():
    rng = np.random.default_rng(4)
    t = _tree_np(rng)
    assert float(tadamw.global_norm(_to_torch(t))) == pytest.approx(
        float(jadamw.global_norm(t)), rel=1e-6)


def test_ef_accumulate_matches():
    rng = np.random.default_rng(5)
    acc = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _tree_np(rng))
    res = jax.tree.map(lambda a: 1e-3 * a, _tree_np(rng))
    g = _tree_np(rng)
    ja, jr = jef(acc, res, g)
    ta, tr = tef(convert.lm_params_from_jax(jax.tree.map(np.asarray, acc)),
                 _to_torch(res), _to_torch(g))
    for got, want in zip(tree.leaves(ta) + tree.leaves(tr),
                         jax.tree.leaves(ja) + jax.tree.leaves(jr)):
        np.testing.assert_array_equal(np32(got), np32(want))


# ---------------------------------------------------------------------------
# make_train_step against the reference's jitted step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def step_pair():
    """The reduced qwen1.5-0.5b in float32 through both packages: models,
    initial states and a batch of 4 sequences of 16 tokens."""
    jm, params, tm = lm_pair("qwen1.5-0.5b")
    jo, to = jadamw.AdamWConfig(**OPT), tadamw.AdamWConfig(**OPT)
    seq = lm_inputs(jm.cfg, 4, 17, seed=1)
    batch = {"inputs": seq[:, :-1], "targets": seq[:, 1:]}
    js = jstep.TrainState(params=params, opt=jadamw.init(jo, params),
                          step=jnp.zeros((), jnp.int32))
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, params))
    ts = tstep.TrainState(params=tparams, opt=tadamw.init(to, tparams),
                          step=torch.zeros((), dtype=torch.int32))
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    return (jm, jo, js, batch), (tm, to, ts, tbatch)


@pytest.mark.parametrize("microbatches,accum,remat", [
    (1, "float32", "none"), (1, "float32", "full"), (1, "float32", "dots"),
    (4, "float32", "none"), (4, "bfloat16", "full"), (4, "bfloat16", "dots")])
def test_train_step_matches_the_reference(step_pair, microbatches, accum,
                                          remat):
    """Metrics and moments within 1e-5; params within a tenth of the
    step's learning rate: Adam's first step is g / (|g| + eps) elementwise,
    which turns a float32 rounding of a gradient element near eps (1e-8)
    into a move of up to the learning rate.  The key bias has such
    elements (27 of its 128 below 1e-7: a softmax does not see a shift
    shared by all keys, and RoPE barely rotates the slowest pairs over 16
    positions); the worst is 0.032 of the learning rate apart,
    ``layers/attn/bk``.  The moments pin the gradient."""
    (jm, jo, js, batch), (tm, to, ts, tbatch) = step_pair
    jn, jmet = jax.jit(jstep.make_train_step(
        jm, jo, microbatches=microbatches, remat=remat,
        accum_dtype=accum))(js, batch)
    tn, tmet = tstep.make_train_step(
        tm, to, microbatches=microbatches, remat=remat,
        accum_dtype=accum)(ts, tbatch)
    assert set(tmet) == set(jmet)
    for k in jmet:
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-5), k
    _assert_trees_close(tn.opt.m, jn.opt.m, 1e-5, "m")
    _assert_trees_close(tn.opt.v, jn.opt.v, 1e-5, "v")
    lr = tmet["lr"]
    for (path, got), want in zip(tree.flatten_with_paths(tn.params),
                                 jax.tree.leaves(jn.params)):
        err = float(np.abs(np32(got) - np.asarray(want)).max())
        assert err <= 0.1 * lr, (path, err / lr)
    assert int(tn.step) == int(jn.step) == 1
    assert int(tn.opt.step) == int(jn.opt.step) == 1
    # the input state is untouched (the Trainer's retry relies on it)
    for a, b in zip(tree.leaves(ts.params),
                    jax.tree.leaves(js.params)):
        np.testing.assert_array_equal(np32(a), np.asarray(b))


def test_bad_batch_leaves_the_state_usable(step_pair):
    _, (tm, to, ts, tbatch) = step_pair
    step = tstep.make_train_step(tm, to, microbatches=3, remat="full")
    with pytest.raises(ValueError, match="microbatches"):
        step(ts, tbatch)                  # 4 rows do not split into 3
    good = tstep.make_train_step(tm, to, remat="none")
    a, _ = good(ts, tbatch)
    b, _ = good(ts, tbatch)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The params tree: the reference's layout, and the state-dict round trip
# ---------------------------------------------------------------------------

ONE_PER_FAMILY = ["qwen1.5-0.5b", "deepseek-v2-lite-16b", "rwkv6-1.6b",
                  "zamba2-7b", "musicgen-large", "llava-next-34b"]


@pytest.mark.parametrize("arch", ONE_PER_FAMILY)
def test_params_tree_has_the_reference_layout(arch):
    jparams = jax.eval_shape(jbuild(jget(arch, reduced=True)).init,
                             jax.random.PRNGKey(0))
    model = tbuild(tget(arch, reduced=True), device="cpu")
    ttree = convert.lm_params_tree(model.state_dict())
    want = [("/".join(k.key for k in path), tuple(leaf.shape),
             str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jparams)[0]]
    got = [("/".join(path), tuple(t.shape), str(t.dtype).replace(
        "torch.", "")) for path, t in tree.flatten_with_paths(ttree)]
    assert got == want


@pytest.mark.parametrize("arch", ONE_PER_FAMILY)
def test_state_dict_round_trip_is_the_identity(arch):
    model = tbuild(tget(arch, reduced=True), device="cpu")
    sd = model.state_dict()
    back = convert.lm_state_dict_from_tree(convert.lm_params_tree(sd))
    assert set(back) == set(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t), k
    model.load_state_dict(back, strict=True)
