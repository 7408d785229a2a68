"""The dense-family LM (``DenseLM``) of the JAX package and of the port
(``device="cpu"``), arch by arch, on the reduced configs in float32 with the
same weights (``convert.lm_state_dict_from_jax``) and the same inputs from
a numpy seed: ``forward`` (all and last logits), ``prefill`` (last logits
and every decode-state tensor) and three ``decode_step``s.  Bar: relative
error (max |port - reference| / max |reference|) below 1e-4.  bf16: one
case per attention kind (GQA, MLA) below 2e-2.  The reference's calls are
jitted, once per arch (a module-scoped fixture)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.configs.base import registry as jregistry
from repro_torch import convert
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import registry as tregistry
from repro_torch.models.transformer import DenseLM

from test_torch_parity_helpers import (clone_state, lm_inputs, lm_pair, np32,
                                       rel_err)

DENSE_ARCHS = ["deepseek-v2-lite-16b", "gemma-2b", "granite-3-2b",
               "llava-next-34b", "musicgen-large", "qwen1.5-0.5b",
               "qwen3-8b", "qwen3-moe-235b-a22b"]
B, S, STEPS, EXTRA = 2, 12, 3, 8
REL = 1e-4


def run_pair(arch, dtype="float32", **overrides):
    """Both packages through forward, prefill and STEPS decodes of one
    batch; returns {name: (port, reference)}."""
    jm, params, tm = lm_pair(arch, dtype, **overrides)
    seq = lm_inputs(jm.cfg, B, S + STEPS)
    fwd = jax.jit(jm.forward, static_argnames=("logits_mode",))
    pre = jax.jit(jm.prefill, static_argnames=("max_len",))
    dec = jax.jit(jm.decode_step)
    out = {}
    with torch.inference_mode():
        tseq = torch.from_numpy(seq)
        out["forward_all"] = (tm.forward(tseq), fwd(params, seq))
        out["forward_last"] = (tm.forward(tseq[:, :S], logits_mode="last"),
                               fwd(params, seq[:, :S], logits_mode="last"))
        tstate, tlog = tm.prefill(tseq[:, :S], max_len=S + EXTRA)
        jstate, jlog = pre(params, seq[:, :S], max_len=S + EXTRA)
        out["prefill_logits"] = (tlog, jlog)
        out["prefill_state"] = (clone_state(tstate), jstate)
        for i in range(STEPS):
            tok = seq[:, S + i:S + i + 1]
            tstate, tlog = tm.decode_step(tstate, torch.from_numpy(tok))
            jstate, jlog = dec(params, jstate, tok)
            out[f"decode_{i}"] = (tlog, jlog)
        out["decode_state"] = (tstate, jstate)
    return out


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def pair(request):
    return request.param, run_pair(request.param)


def test_forward_all_logits(pair):
    arch, out = pair
    got, want = out["forward_all"]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) < REL, arch


def test_forward_last_logits(pair):
    arch, out = pair
    got, want = out["forward_last"]
    assert got.shape == want.shape == (B, 1, got.shape[-1])
    assert rel_err(got, want) < REL, arch


def test_prefill_logits_and_decode_state(pair):
    """Every tensor of the prefill's decode state: same tree, shapes and
    dtypes as the reference's, values within the bar, same length."""
    arch, out = pair
    assert rel_err(*out["prefill_logits"]) < REL, arch
    got, want = out["prefill_state"]
    assert set(got) == set(want)
    assert int(got["length"]) == int(want["length"]) == S
    for group in set(want) - {"length"}:
        assert set(got[group]) == set(want[group])
        for name, w in want[group].items():
            g = got[group][name]
            assert tuple(g.shape) == w.shape, (group, name)
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
            assert rel_err(g, w) < REL, (arch, group, name)
            np.testing.assert_array_equal(np32(g)[:, :, S:], 0)


def test_three_decode_steps(pair):
    arch, out = pair
    for i in range(STEPS):
        got, want = out[f"decode_{i}"]
        assert got.shape == want.shape == (B, 1, got.shape[-1])
        assert rel_err(got, want) < REL, (arch, i)
    got, want = out["decode_state"]
    assert int(got["length"]) == int(want["length"]) == S + STEPS
    for group in set(want) - {"length"}:
        for name, w in want[group].items():
            assert rel_err(got[group][name], w) < REL, (arch, group, name)


@pytest.mark.parametrize("arch", ["qwen3-8b", "deepseek-v2-lite-16b"])
def test_bf16_per_attention_kind(arch):
    """bf16 weights and activations: GQA (qwen3-8b) and MLA
    (deepseek-v2-lite) within 2e-2 of the reference's logits."""
    out = run_pair(arch, dtype="bfloat16")
    for name in ("forward_all", "forward_last", "prefill_logits",
                 *(f"decode_{i}" for i in range(STEPS))):
        got, want = out[name]
        assert got.dtype == torch.bfloat16
        assert rel_err(got, want) < 2e-2, (arch, name)


def test_int8_kv_cache_decode():
    """kv_cache_dtype='int8' (the reference's _decode_scan_quant): the int8
    values and bf16 scales of the prefill equal the reference's, and the
    decode logits are within the bar."""
    out = run_pair("qwen3-8b", kv_cache_dtype="int8")
    got, want = out["prefill_state"]
    for name in ("k", "v", "ks", "vs"):
        assert str(got["scan"][name].dtype).removeprefix("torch.") == \
            str(want["scan"][name].dtype)
        np.testing.assert_array_equal(np32(got["scan"][name]),
                                      np32(want["scan"][name]))
    for i in range(STEPS):
        assert rel_err(*out[f"decode_{i}"]) < REL, i


def test_forward_window_override_and_aux():
    """forward(window=...) masks as the reference's; return_aux and the
    MoE loss terms match."""
    jm, params, tm = lm_pair("qwen3-moe-235b-a22b")
    seq = lm_inputs(jm.cfg, B, S)
    tgt = lm_inputs(jm.cfg, B, S, seed=2)
    want, waux = jax.jit(lambda p, x: jm.forward(p, x, window=4,
                                                 return_aux=True))(params, seq)
    with torch.inference_mode():
        got, gaux = tm.forward(torch.from_numpy(seq), window=4,
                               return_aux=True)
        gl, gm = tm.loss({"inputs": torch.from_numpy(seq),
                          "targets": torch.from_numpy(tgt)})
    wl, wm = jax.jit(jm.loss)(params, {"inputs": seq, "targets": tgt})
    assert rel_err(got, want) < REL
    for name in ("load_balance_loss", "dropped_fraction"):
        np.testing.assert_allclose(float(gaux[name]), float(waux[name]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    assert set(gm) == set(wm)
    for name in wm:
        np.testing.assert_allclose(float(gm[name]), float(wm[name]),
                                   rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# configs, build_model, the weight converter
# ---------------------------------------------------------------------------

ALL_ARCHS = sorted(jregistry())


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_copy_equals_reference(arch):
    assert sorted(tregistry()) == ALL_ARCHS
    for reduced in (False, True):
        t, j = tget(arch, reduced), jget(arch, reduced)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert tget(arch).compute_dtype == torch.bfloat16
    with pytest.raises(KeyError, match="unknown arch"):
        tget("no-such-arch")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        DenseLM(tget("granite-3-2b", reduced=True))


@pytest.mark.parametrize("arch,leaves", [("deepseek-v2-lite-16b", 29),
                                         ("qwen3-8b", 14)])
def test_state_dict_from_jax_tree(arch, leaves):
    """The tree's leaves unstack into the model's weights one to one; a
    bf16 leaf crosses bit for bit; an extra leaf, a wrong shape and a
    missing leaf raise."""
    cfg = jget(arch, reduced=True)
    from repro.models.transformer import build_model as jbuild
    params = jax.tree.map(np.asarray,
                          jbuild(cfg).init(jax.random.PRNGKey(0)))
    assert len(jax.tree.leaves(params)) == leaves
    tcfg = tget(arch, reduced=True)
    sd = convert.lm_state_dict_from_jax(tcfg, params)
    model = DenseLM(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(sd["layers.1.ln1"].numpy(),
                                  params["layers"]["ln1"][1])
    emb = params["embed"]
    assert emb.dtype.name == "bfloat16" and sd["embed"].dtype == \
        torch.bfloat16
    np.testing.assert_array_equal(sd["embed"].view(torch.uint16).numpy(),
                                  emb.view(np.uint16))
    with pytest.raises(ValueError, match="not consumed"):
        convert.lm_state_dict_from_jax(tcfg, {**params,
                                              "extra": np.zeros(3)})
    bad = {**params, "final_norm": np.ones(cfg.d_model + 1, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        convert.lm_state_dict_from_jax(tcfg, bad)
    with pytest.raises(ValueError, match="lacks"):
        convert.lm_state_dict_from_jax(
            tcfg, {k: v for k, v in params.items() if k != "final_norm"})
