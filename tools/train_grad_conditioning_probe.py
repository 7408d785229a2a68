#!/usr/bin/env python3
"""How far the port's training gradients sit from the JAX package's, and
how far the reference moves from itself, on the reduced configs in
float32 (the CPU; JAX and the port side by side, as the parity tests).

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python3 \
        tools/train_grad_conditioning_probe.py [--arch rwkv6-1.6b ...]
        [--seeds 4] [--perturbations 3]

For each arch and input seed s (``lm_inputs(cfg, 2, 17, seed=s)``: inputs
its first 16 tokens, targets its last 16; ``lm_pair`` weights), prints one
JSON line with

  port          the worst leaf of max |port - reference| / max |reference|
                (``train.step.value_and_grad`` against the reference's
                eager ``jax.value_and_grad`` of ``model.loss``);
  jit           the same between the reference's eager and jitted
                gradients (XLA's own rounding spread);
  ulp           per perturbation, the same between the reference's
                jitted gradients at the weights and at the weights with
                every element scaled by 1 +- 1.2e-7 (one float32 ulp, the
                sign drawn per element): how ill-conditioned the gradient
                is at this point.

This is what set the gradient bars of ``tests/test_torch_train_grads.py``
(ROADMAP C38)."""
import argparse
import json
import sys

import jax
import numpy as np
import torch

from repro_torch import convert, tree
from repro_torch.train import step as tstep

from test_torch_parity_helpers import lm_inputs, lm_pair, rel_err


def worst(a_leaves, b_leaves, names):
    return max((rel_err(a, b), n) for a, b, n in zip(a_leaves, b_leaves,
                                                     names))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+",
                    default=["qwen1.5-0.5b", "deepseek-v2-lite-16b",
                             "rwkv6-1.6b", "zamba2-7b"])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--perturbations", type=int, default=3)
    args = ap.parse_args(argv)
    for arch in args.arch:
        jm, params, tm = lm_pair(arch)
        tparams = convert.lm_params_from_jax(jax.tree.map(np.asarray,
                                                          params))
        vg = jax.value_and_grad(jm.loss, has_aux=True)
        jvg = jax.jit(vg)
        rng = np.random.default_rng(5)
        for seed in range(args.seeds):
            seq = lm_inputs(jm.cfg, 2, 17, seed=seed)
            batch = {"inputs": seq[:, :-1], "targets": seq[:, 1:]}
            _, ge = vg(params, batch)
            _, gj = jvg(params, batch)
            _, _, tg = tstep.value_and_grad(
                tm, tparams, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()})
            names = ["/".join(p) for p, _ in tree.flatten_with_paths(tg)]
            ref = [np.asarray(x) for x in jax.tree.leaves(ge)]
            ulp = []
            for _ in range(args.perturbations):
                moved = jax.tree.map(lambda a: a * (1 + np.float32(
                    1.2e-7) * rng.choice([-1, 1], a.shape).astype(
                        np.float32)), params)
                _, gp = jvg(moved, batch)
                ulp.append(worst([np.asarray(x) for x in jax.tree.leaves(gp)],
                                 [np.asarray(x) for x in jax.tree.leaves(gj)],
                                 names))
            print(json.dumps({
                "arch": arch, "seed": seed,
                "port": worst(tree.leaves(tg), ref, names),
                "jit": worst([np.asarray(x) for x in jax.tree.leaves(gj)],
                             ref, names),
                "ulp": ulp}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
