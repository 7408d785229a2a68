"""The train step: remat policy, microbatch gradient accumulation (with
optional bf16 error feedback), AdamW update.

  state = init_train_state(model, opt_cfg)
  train_step = make_train_step(model, opt_cfg, microbatches=2, remat="full")
  state, metrics = train_step(state, batch)

``TrainState.params`` is the JAX package's params tree, stacked layout and
all (``layers/attn/wq`` of shape (L, ...), ``mamba_groups`` on two axes;
``convert.lm_params_tree``), so AdamW, ``global_norm``, the checkpoint's
keys and the gradients match the reference leaf for leaf.  Each gradient
evaluation splits the tree into the module's per-layer names once with
``torch.unbind`` (``convert.lm_state_dict_from_tree``) and runs
``model.loss`` on those views (``models.transformer.call_with``); the
module's own weights stay frozen and serving is unchanged.

A step writes nothing it is given: a step that raises leaves its input
state usable (the Trainer's retry restarts from it or from a
checkpoint).  ``TrainState.step`` and ``AdamWState.step`` are 0-d int32
tensors on the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import convert, tree
from repro_torch.models.transformer import build_model, call_with
from repro_torch.optim import adamw
from repro_torch.optim.compress import ef_accumulate


class TrainState(NamedTuple):
    params: object
    opt: adamw.AdamWState
    step: torch.Tensor                # 0-d int32, on the host


def init_train_state(model, opt_cfg: adamw.AdamWConfig,
                     generator: torch.Generator = None) -> TrainState:
    """Zero moments and the params tree of the model's weights, or, given
    ``generator``, of weights drawn afresh from it on the model's device
    (``model.init(key)`` in the reference).  The layer stacks are new
    tensors; a leaf outside them (``embed``, ``final_norm``, ``shared``)
    shares the module's storage until the first step replaces it: nothing
    writes either in place."""
    src = model if generator is None else build_model(
        model.cfg, device=model.device, generator=generator)
    params = convert.lm_params_tree(src.state_dict())
    return TrainState(params=params, opt=adamw.init(opt_cfg, params),
                      step=torch.zeros((), dtype=torch.int32))


def value_and_grad(model, params, batch):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; grads in
    the tree's layout and the leaves' dtypes, zeros for an unused leaf."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    weights = convert.lm_state_dict_from_tree(tree.unflatten(params, leaves))
    loss, metrics = call_with(model, weights, model.loss, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(params, grads))


def make_train_step(model, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, remat: str = "full",
                    accum_dtype: str = "float32") -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches`` splits the batch's leading axis; their gradients are
    summed in float32, or in bf16 with an fp32 error-feedback residual
    (``accum_dtype='bfloat16'``, ``optim/compress.py``), and averaged.
    ``remat`` is the model's activation checkpointing (``none``, ``full``,
    ``dots``)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {remat!r}")
    if accum_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown accumulation dtype {accum_dtype!r}")
    model.remat = remat

    def train_step(state: TrainState, batch):
        params = state.params
        with torch.enable_grad():
            if microbatches == 1:
                loss, metrics, grads = value_and_grad(model, params, batch)
            else:
                loss, grads = _accumulated(model, params, batch,
                                           microbatches, accum_dtype)
                metrics = {"ce": loss}
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, state.opt, params, grads)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return TrainState(params=new_params, opt=new_opt,
                          step=torch.tensor(int(state.step) + 1,
                                            dtype=torch.int32)), metrics

    return train_step


def _accumulated(model, params, batch, microbatches, accum_dtype):
    """The mean loss and gradient over the batch's ``microbatches``
    slices of its leading axis, one after the other."""
    def split(a):
        b = a.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} must divide into {microbatches} "
                             "microbatches")
        return a.reshape((microbatches, b // microbatches) + a.shape[1:])

    mb = {k: split(v) for k, v in batch.items()}
    loss_sum = None
    if accum_dtype == "bfloat16":
        acc = tree.map(lambda p: torch.zeros_like(p, dtype=torch.bfloat16),
                       params)
        res = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    else:
        acc = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    for i in range(microbatches):
        loss, _, g = value_and_grad(model, params,
                                     {k: v[i] for k, v in mb.items()})
        loss_sum = loss if loss_sum is None else loss_sum + loss
        if accum_dtype == "bfloat16":
            acc, res = ef_accumulate(acc, res, g)
        else:
            for a, gg in zip(tree.leaves(acc), tree.leaves(g)):
                a.add_(gg.float())
    if accum_dtype == "bfloat16":
        grads = tree.map(lambda a, r: (a.float() + r) / microbatches,
                         acc, res)
    else:
        grads = tree.map(lambda a: a / microbatches, acc)
    return loss_sum / microbatches, grads
