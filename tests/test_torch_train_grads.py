"""Gradients of the port's training path against ``jax.value_and_grad`` of
the JAX package's ``model.loss``, leaf for leaf, for one arch of each LM
family on its reduced config in float32 (``lm_pair`` weights, B = 2,
S = 16, the same batch through both).  The port evaluates ``model.loss``
on views of the params tree (``train.step.value_and_grad``), with each
of the three remat policies.

Bar: per leaf, max |port - reference| / max |reference| below 1e-5 for
the dense GQA arch and the MLA + MoE arch (the load-balance term
included; this is the first parity test of the MoE backward on either
side); 1e-4 for RWKV6 and 5e-4 for the Mamba2 hybrid (ROADMAP C38).  On
these random-weight reduced models the recurrent families' float32
gradients are ill-conditioned.  ``tools/train_grad_conditioning_probe.py``
over four input seeds: the port's worst leaf is 7.1e-5 from the
reference's for rwkv6-1.6b (``layers/tm/wr``, this batch) and 5.7e-5 for
zamba2-7b (``mamba_groups/m/a_log``, this batch), while a one-ulp
perturbation of the reference's own weights moves its gradients on this
batch by 1.3e-4 to 3.6e-4 (rwkv6-1.6b) and 3.8e-5 to 1.2e-4 (zamba2-7b);
on every arch and seed the port sits no farther from the reference than
the largest of three such perturbations moves it."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.train import step as tstep

from test_torch_parity_helpers import lm_inputs, lm_pair, rel_err

B, S = 2, 16
BARS = {"qwen1.5-0.5b": 1e-5, "deepseek-v2-lite-16b": 1e-5,
        "rwkv6-1.6b": 1e-4, "zamba2-7b": 5e-4}


def _batch(cfg):
    seq = lm_inputs(cfg, B, S + 1, seed=1)
    if cfg.input_mode == "tokens":
        return {"inputs": seq[:, :-1], "targets": seq[:, 1:]}
    rng = np.random.default_rng(2)
    return {"inputs": seq[:, :-1],
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def run_grads(arch):
    """The reference's (eager) loss and gradient tree, and the port's
    under each remat policy, for one arch."""
    jm, params, tm = lm_pair(arch)
    batch = _batch(jm.cfg)
    (jloss, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        params, batch)
    tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray, params))
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    port = {}
    for remat in ("none", "full", "dots"):
        tm.remat = remat
        port[remat] = tstep.value_and_grad(tm, tparams, tbatch)
    return arch, (jloss, jmet, jg), port


# the dense GQA and RWKV6 archs here; the MLA + MoE and hybrid archs, whose
# reference gradients take longest, in test_torch_train_grads_moe_hybrid.py
@pytest.fixture(scope="module", params=["qwen1.5-0.5b", "rwkv6-1.6b"])
def grads(request):
    return run_grads(request.param)


def test_loss_and_metrics_match(grads):
    arch, (jloss, jmet, _), port = grads
    loss, metrics, _ = port["none"]
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), arch
    assert set(metrics) == set(jmet), arch
    for k in jmet:
        assert abs(float(metrics[k]) - float(jmet[k])) <= 1e-5 * max(
            1.0, abs(float(jmet[k]))), (arch, k)


def test_every_leaf_matches_the_reference(grads):
    arch, (_, _, jg), port = grads
    _, _, tg = port["none"]
    pairs = tree.flatten_with_paths(tg)
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert ["/".join(p) for p, _ in pairs] == [
        "/".join(k.key for k in path) for path, _ in jleaves]
    worst = max((rel_err(g, np.asarray(j)), "/".join(p))
                for (p, g), (_, j) in zip(pairs, jleaves))
    assert worst[0] < BARS[arch], (arch, worst)
    for (p, g), (_, j) in zip(pairs, jleaves):
        assert g.shape == j.shape and g.dtype == torch.float32, p
        assert float(np.abs(np.asarray(j)).max()) > 0 or float(
            g.abs().max()) == 0, p


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_leaves_the_gradient_unchanged(grads, remat):
    """Recomputation runs the same operations on the same tensors: the
    gradients equal those without remat bit for bit on the CPU."""
    arch, _, port = grads
    want, got = port["none"], port[remat]
    assert float(got[0]) == float(want[0])
    for a, b in zip(tree.leaves(got[2]), tree.leaves(want[2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
