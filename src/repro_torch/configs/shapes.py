"""Assigned input shapes × architecture support matrix.

Four shapes per arch (40 cells).  ``train_*`` runs a train step;
``prefill_*`` a full-sequence forward; ``decode_*`` / ``long_*`` one serve
step (one new token against a KV cache of seq_len).  long_500k needs
sub-quadratic attention: only the SSM / hybrid archs run it (the 8 pure
full-attention archs record a documented skip).

:func:`input_specs` gives each input as a tensor on the ``meta`` device —
shapes and dtypes, no memory — as the JAX package's ``ShapeDtypeStruct``
stand-ins do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: InputShape
                   ) -> Tuple[bool, str]:
    """Whether (arch × shape) is a runnable cell, with the reason if not."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: unbounded KV/state at "
                       "524k — sub-quadratic attention required (skip per "
                       "assignment; see DESIGN.md §4)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape,
                model=None) -> Dict[str, object]:
    """Meta-device stand-ins for every input of the cell's step.

    train  -> {"inputs", "targets"}
    prefill-> {"inputs"}
    decode -> {"inputs", "state": <decode state, every tensor on meta>}

    Tokens are int32 (B, S); the embeds archs take (B, S, d_model) in the
    compute dtype.  ``model`` (a meta build of ``cfg``) is built when not
    given."""
    b, s = shape.batch, shape.seq
    if cfg.input_mode == "tokens":
        def inp(batch, seq):
            return _meta((batch, seq), torch.int32)
    else:
        def inp(batch, seq):
            return _meta((batch, seq, cfg.d_model), cfg.compute_dtype)

    if shape.kind == "train":
        return {"inputs": inp(b, s), "targets": _meta((b, s), torch.int32)}
    if shape.kind == "prefill":
        return {"inputs": inp(b, s)}
    if shape.kind == "decode":
        if model is None:
            from repro_torch.models.transformer import build_model
            model = build_model(cfg, device="meta")
        # a cache of seq_len tokens already filled, decoding token seq_len+1
        return {"inputs": inp(b, 1),
                "state": model.init_decode_state(b, s)}
    raise ValueError(shape.kind)
