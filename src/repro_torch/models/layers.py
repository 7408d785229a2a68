"""Shared building blocks for the model zoo.

Conventions (the JAX package's, carried over):
  * weights are grouped as the reference's params dicts are (``Params``:
    ``p["wq"]``, ``"bq" in p``), and a weight keeps the reference's layout,
    so ``x @ w`` needs no transpose;
  * init functions draw from an explicit ``torch.Generator`` on the device
    the weights live on;
  * compute dtype is configurable (bf16 default), accumulation and
    normalization in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """A named group of weights, read like the reference's params dict.

    Tensors become (frozen) parameters, ``Params`` values sub-groups, so
    ``state_dict`` names follow the reference's tree (``attn.wq``,
    ``moe.shared.wo``)."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def rms_norm(x, scale, eps: float = 1e-6, offset: float = 0.0):
    """RMSNorm in fp32 (gemma uses (1+scale) — pass offset=1.0)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (offset + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias=None, eps: float = 1e-5):
    """LayerNorm in fp32 (RWKV blocks use LN, not RMSNorm)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _device(generator: torch.Generator) -> torch.device:
    """Where weights land: the generator's device, or the meta device while
    a model's skeleton is built (no memory, no draws)."""
    default = torch.get_default_device()
    return default if default.type == "meta" else generator.device


def normal(generator: torch.Generator, shape, std: float,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Standard-normal draws in fp32 on the generator's device, times
    ``std``, cast to ``dtype``."""
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=_device(generator)) * std).to(dtype)


def init_dense(generator, in_dim: int, out_dim: int, dtype=torch.bfloat16,
               scale: Optional[float] = None):
    s = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal(generator, (in_dim, out_dim), s, dtype)


def init_embed(generator, vocab: int, dim: int, dtype=torch.bfloat16):
    return normal(generator, (vocab, dim), 0.02, dtype)


def ones(generator, n: int, dtype=torch.float32):
    """A norm scale of ones on the generator's device."""
    return torch.ones((n,), dtype=dtype, device=_device(generator))


def zeros(generator, n: int, dtype):
    return torch.zeros((n,), dtype=dtype, device=_device(generator))


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-halves layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLPs
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model: int, d_ff: int, dtype=torch.bfloat16):
    return Params(
        wi_gate=init_dense(generator, d_model, d_ff, dtype),
        wi_up=init_dense(generator, d_model, d_ff, dtype),
        wo=init_dense(generator, d_ff, d_model, dtype))


def mlp(params, x, activation: str = "silu"):
    """SwiGLU (llama-family) or GeGLU (gemma)."""
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    if activation == "silu":
        act = F.silu(gate.float())
    elif activation == "gelu":
        act = F.gelu(gate.float(), approximate="tanh")
    else:
        raise ValueError(activation)
    return (act.to(x.dtype) * up) @ params["wo"]


def cross_entropy_loss(logits, labels, z_loss: float = 1e-4):
    """Token-mean cross entropy with z-loss regularization; fp32 reduction.

    logits: (..., V); labels: (...), negative entries are masked.
    """
    logits = logits.float()
    mask = labels >= 0
    safe = labels.clamp(min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / denom
