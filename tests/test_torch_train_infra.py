"""Training substrate of the port on the CPU: the twins of
``tests/test_train_infra.py``'s eleven tests (optimizer schedule, loss
falling, microbatch equivalence, remat equivalence, error feedback,
trainer resume exactness, straggler detection, checkpoints, the counted
pipeline, and a restore into a template of another dtype in place of the
reference's elastic restart across device counts) and of
``tests/test_models.py::test_smoke_forward_and_train_step`` for one arch
per family, all fast enough for tier 1; checkpoints written by either
package restored in the other with equal arrays (bf16 included); the
Trainer's retry after an injected failure, async save; the launcher."""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget
from repro.models.transformer import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import (PipelineConfig, TokenPipeline,
                                       pipeline_for_model)
from repro_torch.models.transformer import build_model
from repro_torch.optim import adamw
from repro_torch.optim.compress import ef_accumulate
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step)
from repro_torch.train.trainer import (StragglerMonitor, Trainer,
                                       TrainerConfig)

from test_torch_parity_helpers import np32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    """The reference fixture's set-up: reduced qwen1.5-0.5b (bf16), lr
    1e-3 with 5 warm-up steps of 50, a pipeline of 4 x 16 tokens."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=5,
                                total_steps=50)
    state = init_train_state(model, opt_cfg)
    pipe = pipeline_for_model(cfg, global_batch=4, seq_len=16, device="cpu")
    return cfg, model, opt_cfg, state, pipe


def _equal_trees(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---- the twins of tests/test_train_infra.py ----

def test_loss_decreases(tiny):
    cfg, model, opt_cfg, state, pipe = tiny
    step = make_train_step(model, opt_cfg, remat="none")
    first = last = None
    for i in range(15):
        state, m = step(state, pipe.batch_at(i))
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first


def test_microbatch_equivalence(tiny):
    """fp32 accumulation over microbatches equals the single-batch gradient
    to bf16 backward noise (the reference's bar), compared at the gradient
    level."""
    from repro_torch.train.step import value_and_grad
    cfg, model, opt_cfg, state, pipe = tiny
    batch = pipe.batch_at(0)
    _, _, g_full = value_and_grad(model, state.params, batch)
    gs = [value_and_grad(model, state.params,
                          {k: v[i:i + 1] for k, v in batch.items()})[2]
          for i in range(4)]
    g_acc = tree.map(lambda *x: sum(xi.float() for xi in x) / 4, *gs)
    for a, b in zip(tree.leaves(g_full), tree.leaves(g_acc)):
        d = float((a.float() - b).abs().max())
        s = float(b.abs().max()) + 1e-9
        assert d / s < 5e-2, (d, s)


def test_remat_grad_equivalence(tiny):
    """Remat changes memory, never gradients."""
    cfg, model, opt_cfg, state, pipe = tiny
    batch = pipe.batch_at(3)
    outs = {pol: make_train_step(model, opt_cfg, remat=pol)(state, batch)[0]
            for pol in ("none", "full", "dots")}
    for pol in ("full", "dots"):
        for a, b in zip(tree.leaves(outs["none"].params),
                        tree.leaves(outs[pol].params)):
            np.testing.assert_allclose(np32(a), np32(b), rtol=1e-3,
                                       atol=1e-5)


def test_ef_accumulation_unbiased():
    """bf16 + error feedback tracks the fp32 sum far better than plain bf16."""
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(256).astype(np.float32) * 1e-2
          for _ in range(64)]
    acc = {"g": torch.zeros(256, dtype=torch.bfloat16)}
    res = {"g": torch.zeros(256, dtype=torch.float32)}
    plain = torch.zeros(256, dtype=torch.bfloat16)
    for g in gs:
        acc, res = ef_accumulate(acc, res, {"g": torch.from_numpy(g)})
        plain = (plain.float() + torch.from_numpy(g)).bfloat16()
    true = np.sum(gs, axis=0)
    ef_total = np32(acc["g"]) + np32(res["g"])
    ef_err = np.abs(ef_total - true).max()
    plain_err = np.abs(np32(plain) - true).max()
    assert ef_err < 1e-6
    assert ef_err < plain_err


def test_adamw_lr_schedule():
    cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100,
                            lr_min_ratio=0.1)
    assert adamw.lr_at(cfg, 0) < adamw.lr_at(cfg, 9)
    assert abs(adamw.lr_at(cfg, 10) - 1e-3) < 1e-4
    assert adamw.lr_at(cfg, 99) < 2.0e-4    # decayed near min


def test_straggler_monitor():
    m = StragglerMonitor(alpha=0.9, sigma=3.0)
    for i in range(50):
        m.observe(i, 0.1 + 0.001 * (i % 3))
    assert not m.flagged            # tight jitter never flags (rel floor)
    m.observe(50, 2.0)              # 20x outlier
    assert m.flagged and m.flagged[-1]["step"] == 50
    # warm-up: an early outlier is NOT flagged (variance not yet trusted)
    m2 = StragglerMonitor(alpha=0.9, sigma=3.0)
    m2.observe(0, 0.1)
    m2.observe(1, 2.0)
    assert not m2.flagged


def test_checkpoint_roundtrip_and_gc(tiny):
    cfg, model, opt_cfg, state, pipe = tiny
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(d, s, state, keep=2)
        assert ckpt.all_steps(d) == [4, 5]          # keep-k GC
        back = ckpt.restore(d, 5, state)
        _equal_trees(state, back)


def test_checkpoint_atomicity(tiny):
    """Orphaned tmp dirs (crashed writers) are invisible to readers and
    garbage-collected by the next save."""
    cfg, model, opt_cfg, state, pipe = tiny
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "step_000000009.tmp-dead"))
        assert ckpt.all_steps(d) == []
        ckpt.save(d, 1, state)
        assert ckpt.all_steps(d) == [1]
        assert not any(".tmp-" in p for p in os.listdir(d))


def test_pipeline_determinism_and_sharding():
    pipe = TokenPipeline(PipelineConfig(vocab=97, global_batch=8,
                                        seq_len=12, seed=3), device="cpu")
    b1 = pipe.batch_at(7)
    b2 = pipe.batch_at(7)
    assert torch.equal(b1["inputs"], b2["inputs"])
    assert not torch.equal(b1["inputs"], pipe.batch_at(8)["inputs"])
    # shards concatenate to the full batch regardless of shard count
    for num in (2, 4):
        parts = [pipe.shard_slice(7, s, num)["inputs"] for s in range(num)]
        assert torch.equal(torch.cat(parts), b1["inputs"])


def test_trainer_resume_exactness(tiny):
    """Train 10 straight vs train 5 + crash + resume 5: identical params
    and moments, bit for bit (checkpoint + counted data stream =>
    sample-exact resume)."""
    cfg, model, opt_cfg, state0, pipe = tiny
    step = make_train_step(model, opt_cfg, remat="none")
    with tempfile.TemporaryDirectory() as d:
        a = Trainer(TrainerConfig(total_steps=10, ckpt_dir=None),
                    step, pipe, state0)
        sa = a.run(start_step=0)
        b1 = Trainer(TrainerConfig(total_steps=5, ckpt_dir=d, ckpt_every=5),
                     step, pipe, state0)
        b1.run(start_step=0)
        b2 = Trainer(TrainerConfig(total_steps=10, ckpt_dir=d),
                     step, pipe, state0)
        sb = b2.run()                      # resumes at 5 from checkpoint
        assert int(sb.step) == int(sa.step) == 10
        _equal_trees(sa, sb)


def test_elastic_restart_reshard():
    """A checkpoint written by another process (the JAX package's ``save``
    in a fresh interpreter) restores into templates of other dtypes: bf16,
    float64, and int64 for the step."""
    with tempfile.TemporaryDirectory() as d:
        code = f"""
import jax.numpy as jnp
from repro.checkpoint import ckpt
tree = {{"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
         "step": jnp.asarray(7, jnp.int32)}}
ckpt.save({d!r}, 7, tree)
"""
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        want = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        for dt in (torch.bfloat16, torch.float64):
            template = {"w": torch.zeros((8, 8), dtype=dt),
                        "step": torch.zeros((), dtype=torch.int64)}
            back = ckpt.restore(d, 7, template)
            assert back["w"].dtype == dt and back["step"].dtype == torch.int64
            assert torch.equal(back["w"], want.to(dt))
            assert int(back["step"]) == 7
        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore(d, 7, {"w": torch.zeros(4, 16), "step":
                                torch.zeros((), dtype=torch.int32)})
        with pytest.raises(KeyError, match="missing leaf"):
            ckpt.restore(d, 7, {"v": torch.zeros(8, 8)})


# ---- test_models.py::test_smoke_forward_and_train_step, one arch a family ----

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-large",
                                  "llava-next-34b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b", "zamba2-7b"])
def test_smoke_forward_and_train_step(arch):
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b, s = 2, 16
    if cfg.input_mode == "tokens":
        inputs = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    else:
        inputs = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    targets = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    batch = {"inputs": inputs, "targets": targets}
    with torch.no_grad():
        logits = model.forward(inputs)
    assert logits.shape == (b, s, cfg.vocab)
    assert bool(torch.isfinite(logits.float()).all())

    opt_cfg = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    state = init_train_state(model, opt_cfg,
                             generator=torch.Generator().manual_seed(0))
    state, metrics = make_train_step(model, opt_cfg, remat="full")(
        state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(p.float()).all())
               for p in tree.leaves(state.params))


# ---- beyond the reference's tests ----

def test_trainer_retries_a_failed_step_from_the_checkpoint(tiny):
    """A step that raises (injected at step 3, once) is retried from the
    latest checkpoint (step 2); the run ends equal to an undisturbed one."""
    cfg, model, opt_cfg, state0, pipe = tiny
    step = make_train_step(model, opt_cfg, remat="none")
    failed = []

    def fault(s):
        if s == 3 and not failed:
            failed.append(s)
            raise RuntimeError("injected")

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean = Trainer(TrainerConfig(total_steps=6, ckpt_dir=d1,
                                      ckpt_every=2), step, pipe, state0)
        want = clean.run()
        hit = Trainer(TrainerConfig(total_steps=6, ckpt_dir=d2,
                                    ckpt_every=2), step, pipe, state0,
                      fault_hook=fault)
        got = hit.run()
    retries = [h for h in hit.history if h.get("event") == "retry"]
    assert len(retries) == 1 and retries[0]["restored_to"] == 2
    _equal_trees(want, got)


def test_trainer_gives_up_after_max_retries(tiny):
    cfg, model, opt_cfg, state0, pipe = tiny

    def always(s):
        raise RuntimeError("down")

    tr = Trainer(TrainerConfig(total_steps=3, max_retries=2),
                 make_train_step(model, opt_cfg, remat="none"), pipe,
                 state0, fault_hook=always)
    with pytest.raises(RuntimeError, match="down"):
        tr.run()
    assert sum(h.get("event") == "retry" for h in tr.history) == 2


def test_async_save_returns_a_thread_and_writes_atomically(tiny):
    cfg, model, opt_cfg, state, pipe = tiny
    with tempfile.TemporaryDirectory() as d:
        t = ckpt.save(d, 4, state, blocking=False)
        t.join(timeout=120)
        assert not t.is_alive()
        assert ckpt.latest_step(d) == 4
        _equal_trees(state, ckpt.restore(d, 4, state))


def _stepped_pair():
    """The reduced qwen1.5-0.5b (bf16 weights, fp32 moments) one jitted
    reference step in, and its port TrainState holding the same arrays."""
    jm = jbuild(jget("qwen1.5-0.5b", reduced=True))
    jo = jadamw.AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    params = jm.init(jax.random.PRNGKey(0))
    js = jstep.TrainState(params=params, opt=jadamw.init(jo, params),
                          step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jm.cfg.vocab, (2, 9)).astype(np.int32)
    js, _ = jax.jit(jstep.make_train_step(jm, jo, remat="none"))(
        js, {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
    host = jax.tree.map(np.asarray, js)
    ts = TrainState(
        params=convert.lm_params_from_jax(host.params),
        opt=adamw.AdamWState(step=torch.tensor(int(host.opt.step),
                                               dtype=torch.int32),
                             m=convert.lm_params_from_jax(host.opt.m),
                             v=convert.lm_params_from_jax(host.opt.v)),
        step=torch.tensor(int(host.step), dtype=torch.int32))
    return js, ts


def _assert_same_arrays(jtree, ttree):
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tleaves = tree.flatten_with_paths(ttree)
    assert len(jleaves) == len(tleaves)
    for (jp, j), (tp, t) in zip(jleaves, tleaves):
        assert str(j.dtype) == str(t.dtype).replace("torch.", ""), tp
        np.testing.assert_array_equal(np32(j), np32(t), err_msg=str(tp))


def test_port_checkpoint_restores_in_the_reference():
    js, ts = _stepped_pair()
    assert any(t.dtype == torch.bfloat16 for t in tree.leaves(ts.params))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, ts)
        template = jax.tree.map(jnp.zeros_like, js)
        back = jckpt.restore(d, 1, template)
    _assert_same_arrays(back, ts)
    _assert_same_arrays(back, js)


def test_reference_checkpoint_restores_in_the_port():
    js, ts = _stepped_pair()
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 1, js)
        manifest = json.load(open(os.path.join(d, "step_000000001",
                                               "manifest.json")))
        template = tree.map(torch.zeros_like, ts)
        back = ckpt.restore(d, 1, template)
        # the port writes the reference's manifest, key for key
        with tempfile.TemporaryDirectory() as d2:
            ckpt.save(d2, 1, back)
            mine = json.load(open(os.path.join(d2, "step_000000001",
                                               "manifest.json")))
    assert mine == manifest
    _assert_same_arrays(js, back)


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch import train as launch
    with tempfile.TemporaryDirectory() as d:
        tr = launch.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps",
                          "3", "--batch", "2", "--seq", "8", "--device",
                          "cpu", "--ckpt-dir", d, "--ckpt-every", "2",
                          "--microbatches", "2", "--remat", "dots"])
        assert ckpt.all_steps(d) == [2, 3]
    printed = capsys.readouterr().out
    assert "[train] rwkv6-1.6b (reduced):" in printed
    lines = [json.loads(x) for x in printed.splitlines()
             if x.startswith("{")]
    assert [h["step"] for h in lines] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in lines)
    assert int(tr.state.step) == 3


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train as launch
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline_for_model(get_config("qwen1.5-0.5b", reduced=True), 2, 8)
