"""GPipe-style pipeline parallelism over a mesh of stages.

Layers are split into S contiguous stages; M microbatches stream through
with a hand-off of activations from stage i to stage i + 1 at every tick.
Each tick every stage runs its layer block on its current microbatch — the
schedule fills in S-1 ticks and runs M+S-1 ticks in all (bubble fraction
(S-1)/(M+S-1)), exactly GPipe.  Stage 0 injects microbatch t at tick t; the
last stage emits microbatch t - (S-1) at tick t.

The mesh is a :class:`~repro_torch.core.distributed.ShardMesh` of S shards:

  emulated       the S stages run in turn within a tick on one device
                 (as the mesh layer emulates its shards, ROADMAP C27); the
                 hand-off is a list rotation;
  process_group  one stage per rank: the right-neighbour hand-off is one
                 ``dist.batch_isend_irecv`` per tick, and the outputs,
                 held by the last stage, reach every rank by an all-reduce
                 of the zero-masked output buffer.

Each hand-off and the collection are recorded (``obs.collectives``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.obs import collectives


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _stage_params(stacked_params, s: int):
    """Per stage, the tree of its L/S layers (views of the stacked
    leaves)."""
    leaves = tree.leaves(stacked_params)
    l_total = leaves[0].shape[0]
    if l_total % s:
        raise ValueError(f"{l_total} layers not divisible by {s} stages")
    per = l_total // s
    return [tree.map(lambda a: a[i * per:(i + 1) * per], stacked_params)
            for i in range(s)], per


def _run_block(layer_fn, block, per: int, x):
    for j in range(per):
        x = layer_fn(tree.map(lambda a: a[j], block), x)
    return x


def pipeline_apply(layer_fn: Callable, stacked_params, x_microbatches,
                   mesh, axis: str = "stage"):
    """Run a stack of layers as a pipeline over ``mesh``'s S shards.

    layer_fn(params_i, x) -> x       one layer, given the layer's slice of
      the stacked tree
    stacked_params: tree with leading axis L (total layers); L must be
      divisible by S.
    x_microbatches: (M, ...) microbatch-major activations.
    Returns (M, ...) outputs, equal to applying all L layers in sequence
    to each microbatch (on every rank of a process group).  ``axis`` names
    the stage axis, as in the JAX package; a ShardMesh has one axis."""
    s = mesh.p
    m = x_microbatches.shape[0]
    blocks, per = _stage_params(stacked_params, s)
    if mesh.rank is None:
        return _emulated(layer_fn, blocks, per, x_microbatches, s, m)
    return _process_group(layer_fn, blocks[mesh.rank], per, x_microbatches,
                          s, m, mesh.rank)


def _emulated(layer_fn, blocks, per, xs, s, m):
    outputs = torch.empty_like(xs)
    held = [None] * s            # what each stage holds at the tick's start
    for t in range(m + s - 1):
        ys = [None] * s
        for i in range(s):
            if not 0 <= t - i < m:           # idle: fill or drain
                continue
            x_in = xs[t] if i == 0 else held[i]
            ys[i] = _run_block(layer_fn, blocks[i], per, x_in)
        # hand-off: stage i -> i + 1 (the last stage emits instead)
        for i in range(s - 1):
            if ys[i] is not None:
                collectives.record("send-recv", _nbytes(ys[i]))
        held = [None] + ys[:-1]
        if ys[-1] is not None:
            outputs[t - (s - 1)] = ys[-1]
    collectives.record("all-reduce", _nbytes(outputs))
    return outputs


def _process_group(layer_fn, block, per, xs, s, m, rank):
    import torch.distributed as dist
    outputs = torch.zeros_like(xs)
    held = torch.empty_like(xs[0])
    for t in range(m + s - 1):
        active = 0 <= t - rank < m
        y = None
        if active:
            x_in = xs[t] if rank == 0 else held
            y = _run_block(layer_fn, block, per, x_in)
            if rank == s - 1:
                outputs[t - (s - 1)] = y
        # right-neighbour hand-off: stage i sends what stage i + 1 takes
        # at tick t + 1
        ops = []
        if rank < s - 1 and active:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), rank + 1))
            collectives.record("send-recv", _nbytes(y))
        if rank > 0 and 0 <= t + 1 - rank < m:
            ops.append(dist.P2POp(dist.irecv, held, rank - 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # the outputs live on the last stage; zeros elsewhere
    dist.all_reduce(outputs)
    collectives.record("all-reduce", _nbytes(outputs))
    return outputs


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
