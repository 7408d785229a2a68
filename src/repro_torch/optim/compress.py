"""Gradient compression: ``ef_accumulate``, bf16 gradient accumulation
across microbatches with an fp32 error-feedback residual.  It halves the
accumulation buffer's bytes while the summed gradient stays unbiased to
fp32 over time (the paper's "fewer bytes in the accumulation step" applied
to training state).  The JAX package's ``compressed_psum`` (collectives
across data-parallel shards) belongs to distributed training and is not
ported here.
"""
from __future__ import annotations

from repro_torch import tree


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
