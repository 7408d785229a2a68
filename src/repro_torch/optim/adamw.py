"""AdamW with global-norm clipping and a linear warm-up / cosine schedule.

Plain functions over trees of tensors (``repro_torch.tree``), the JAX
package's math in the same order: moments in float32 whatever the
parameter's dtype (``moment_dtype='bfloat16'`` stores them in bf16), bias
corrections ``1 - b ** step`` in float32, decoupled weight decay on leaves
with ``ndim >= 2`` only (in the stacked layout a layer stack's norm scales
are such leaves), the new parameter computed in float32 and rounded to the
parameter's dtype.  ``torch.optim.AdamW`` is not used: it decays every
leaf and orders its operations differently.

The step count and the schedule live on the host (``AdamWState.step`` a
0-d int32 CPU tensor, ``lr_at`` a Python float), so an update waits for
nothing on the card.  ``update`` writes no tensor it is given: a step that
raises leaves the state it started from usable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16


class AdamWState(NamedTuple):
    step: torch.Tensor                # 0-d int32, on the host
    m: object
    v: object


def _f32(x) -> np.float32:
    return np.float32(x)


def lr_at(cfg: AdamWConfig, step) -> float:
    """The learning rate of step ``step`` (counted from 0), in float32."""
    step = int(step)
    if step < cfg.warmup_steps:
        return float(_f32(cfg.lr_peak) * _f32(step + 1)
                     / _f32(max(1, cfg.warmup_steps)))
    t = _f32(step - cfg.warmup_steps) / _f32(
        max(1, cfg.total_steps - cfg.warmup_steps))
    t = min(max(t, _f32(0.0)), _f32(1.0))
    cos = _f32(cfg.lr_min_ratio) + _f32(1 - cfg.lr_min_ratio) * _f32(0.5) * (
        _f32(1) + np.cos(_f32(math.pi) * t))
    return float(_f32(cfg.lr_peak) * cos)


def init(cfg: AdamWConfig, params) -> AdamWState:
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32),
        m=tree.map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        v=tree.map(lambda p: torch.zeros_like(p, dtype=mdt), params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [x.float().square().sum() for x in tree.leaves(grads)]
    return torch.stack(sums).sum().sqrt()


def update(cfg: AdamWConfig, state: AdamWState, params, grads):
    """Returns (new_params, new_state, metrics); writes none of its
    arguments."""
    gnorm = global_norm(grads)
    scale = (cfg.clip_norm / gnorm.clamp(min=1e-9)).clamp(max=1.0)
    step = int(state.step) + 1
    lr = lr_at(cfg, int(state.step))
    b1c = float(_f32(1) - _f32(cfg.b1) ** _f32(step))
    b2c = float(_f32(1) - _f32(cfg.b2) ** _f32(step))

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        delta = (m32 / b1c) / ((v32 / b2c).sqrt() + cfg.eps)
        p32 = p.float()
        if p.ndim >= 2:       # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        return ((p32 - lr * delta).to(p.dtype), m32.to(m.dtype),
                v32.to(v.dtype))

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree.leaves(params), tree.leaves(grads), tree.leaves(state.m),
        tree.leaves(state.v), strict=True)]
    new_params = tree.unflatten(params, [o[0] for o in out])
    new_m = tree.unflatten(params, [o[1] for o in out])
    new_v = tree.unflatten(params, [o[2] for o in out])
    new_state = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                           m=new_m, v=new_v)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
