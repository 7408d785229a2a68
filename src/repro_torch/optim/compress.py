"""Gradient compression: the paper's "fewer bytes in the accumulation step"
applied to training state instead of SpMV buffers.

  * ``ef_accumulate`` — bf16 gradient accumulation across microbatches with
    an fp32 error-feedback residual: it halves the accumulation buffer's
    bytes while the summed gradient stays unbiased to fp32 over time;
  * ``compressed_psum`` — the data-parallel all-reduce of a gradient tree
    over a :class:`~repro_torch.core.distributed.ShardMesh`, compressed on
    the wire: bf16 halves the bytes, int8 quarters them with a per-tensor
    max-abs scale (the scale itself max-reduced first).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch import tree
from repro_torch.obs import collectives

MODES = ("float32", "bfloat16", "int8")
_WIRE_BYTES = {"bfloat16": 2, "int8": 1}    # float32: the leaf's own


def _entry_bytes(g: torch.Tensor, mode: str) -> int:
    return _WIRE_BYTES.get(mode, g.element_size())


def ef_accumulate(acc_bf16, residual_f32, grad):
    """One error-feedback accumulation step over trees of tensors.

    acc_bf16: running sum (bf16); residual_f32: fp32 error carry; grad:
    the new fp32 / bf16 microbatch gradient.  Returns (new_acc,
    new_residual); writes none of its arguments."""
    def one(a, r, g):
        want = r + g.float()
        new_a = (a.float() + want).bfloat16()
        return new_a, want - (new_a.float() - a.float())

    out = [one(a, r, g) for a, r, g in zip(
        tree.leaves(acc_bf16), tree.leaves(residual_f32), tree.leaves(grad),
        strict=True)]
    return (tree.unflatten(acc_bf16, [o[0] for o in out]),
            tree.unflatten(acc_bf16, [o[1] for o in out]))


def wire_bytes(tree_, mode: str) -> int:
    """Bytes one shard contributes to a :func:`compressed_psum` of
    ``tree_``: each entry in the leaf's dtype (float32), in 2 bytes (bf16)
    or in 1 byte and each leaf's float32 scale (int8)."""
    leaves = tree.leaves(tree_)
    return sum(t.numel() * _entry_bytes(t, mode)
               + (4 if mode == "int8" else 0) for t in leaves)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _quantize(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g.float() / scale), -127, 127).to(
        torch.int8)


def _amax(g: torch.Tensor) -> torch.Tensor:
    return g.abs().max().float()


def compressed_psum(trees, mesh, mode: str = "bfloat16"):
    """All-reduce a gradient tree over ``mesh`` (a ``ShardMesh``) with
    on-the-wire compression; every shard gets the sum.

    ``mode``, with the JAX package's arithmetic:
      float32   a plain sum in the leaf's dtype;
      bfloat16  each shard's leaves cast to bf16, summed (float32 adds of
                the bf16 values in shard order, one rounding to bf16), cast
                back to the leaf's dtype;
      int8      per leaf the max over shards of each shard's max |g|,
                ``scale = amax / 127`` (1 where amax is 0), each shard's
                values rounded (half to even) and clipped to ±127, the int8
                values summed in int32, times the scale, cast to the leaf's
                dtype.

    Emulated mesh: ``trees`` is a list of p trees, one per shard; returns
    a list of p trees, all the one summed tree (the shards share its
    tensors).  Process-group mesh: ``trees`` is this rank's tree; returns
    the summed tree, the leaves reduced by ``dist.all_reduce`` in the
    compressed dtype (bf16; int8 as int32 sums after a ``MAX`` all-reduce
    of the amax).  Each leaf's all-reduce is recorded
    (``obs.collectives``): the emulated mesh records the payload a shard
    contributes (:func:`wire_bytes`), the process group the bytes of the
    tensors it reduces."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mesh.rank is None:
        return _psum_emulated(trees, mesh, mode)
    return _psum_group(trees, mode)


def _psum_emulated(trees, mesh, mode: str) -> List:
    if len(trees) != mesh.p:
        raise ValueError(f"{len(trees)} trees for a mesh of {mesh.p} "
                         "shards")
    per_shard = [tree.leaves(t) for t in trees]
    out = []
    for gs in zip(*per_shard, strict=True):
        dtype = gs[0].dtype
        if mode == "float32":
            s = gs[0].clone()
            for g in gs[1:]:
                s += g
        elif mode == "bfloat16":
            s = gs[0].to(torch.bfloat16).float()
            for g in gs[1:]:
                s += g.to(torch.bfloat16).float()
            s = s.to(torch.bfloat16).to(dtype)
        else:
            amax = torch.stack([_amax(g) for g in gs]).max()
            scale = _scale(amax)
            s = _quantize(gs[0], scale).to(torch.int32)
            for g in gs[1:]:
                s += _quantize(g, scale)
            s = (s.float() * scale).to(dtype)
            collectives.record("all-reduce", 4)
        collectives.record("all-reduce",
                           gs[0].numel() * _entry_bytes(gs[0], mode))
        out.append(s)
    summed = tree.unflatten(trees[0], out)
    return [summed] * mesh.p


def _psum_group(tree_, mode: str):
    import torch.distributed as dist
    out = []
    for g in tree.leaves(tree_):
        if mode == "float32":
            s = g.clone()
            dist.all_reduce(s)
            collectives.record("all-reduce", s.numel() * s.element_size())
            out.append(s)
        elif mode == "bfloat16":
            s = g.to(torch.bfloat16).clone()
            dist.all_reduce(s)
            collectives.record("all-reduce", s.numel() * 2)
            out.append(s.to(g.dtype))
        else:
            amax = _amax(g).reshape(1)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
            scale = _scale(amax[0])
            s = _quantize(g, scale).to(torch.int32)
            dist.all_reduce(s)
            collectives.record("all-reduce", 4)
            collectives.record("all-reduce", s.numel() * 4)
            out.append((s.float() * scale).to(g.dtype))
    return tree.unflatten(tree_, out)
