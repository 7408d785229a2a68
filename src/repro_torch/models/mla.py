"""Multi-head Latent Attention (DeepSeek-V2) — compressed-KV attention.

Train/prefill materializes per-head K/V from the latent; decode uses the
*absorbed* formulation: the query is projected into the latent space
(q_abs = q_nope @ W_uk) so the cache stores only (c_kv: r, k_rope: dr) per
token — 576 values/token for V2-Lite vs n_heads*(dk+dv) = 4096 for vanilla
MHA.  The scores are two fp32 contractions, one over the latent cache and
one over the rope cache, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch

from .attention import _position, _scores, _slot, attention
from .layers import Params, apply_rope, init_dense, normal, ones, rms_norm


def init_mla(generator, d_model: int, n_heads: int, kv_lora: int,
             nope_dim: int, rope_dim: int, v_dim: int, dtype=torch.bfloat16):
    return Params(
        w_dkv=init_dense(generator, d_model, kv_lora + rope_dim, dtype),
        ckv_norm=ones(generator, kv_lora),
        w_uk=normal(generator, (kv_lora, n_heads, nope_dim),
                    kv_lora ** -0.5, dtype),
        w_uv=normal(generator, (kv_lora, n_heads, v_dim),
                    kv_lora ** -0.5, dtype),
        w_q=normal(generator, (d_model, n_heads, nope_dim + rope_dim),
                   d_model ** -0.5, dtype),
        w_o=normal(generator, (n_heads, v_dim, d_model),
                   (n_heads * v_dim) ** -0.5, dtype))


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, T, r)
    k_rope: torch.Tensor     # (B, T, dr)
    length: Union[int, torch.Tensor]


def init_mla_cache(batch: int, max_len: int, kv_lora: int, rope_dim: int,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, max_len, rope_dim), dtype=dtype,
                           device=device),
        length=0)


def _latents(params, x, positions, kv_lora, rope_theta):
    c = x @ params["w_dkv"]
    c_kv, k_rope_raw = c[..., :kv_lora], c[..., kv_lora:]
    c_kv = rms_norm(c_kv, params["ckv_norm"])
    k_rope = apply_rope(k_rope_raw[:, :, None, :], positions, rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_forward(params, x, positions, *, n_heads, kv_lora, nope_dim,
                rope_dim, v_dim, rope_theta=10000.0, kv_chunk=2048):
    """Materialized train/prefill path."""
    b, s, _ = x.shape
    c_kv, k_rope = _latents(params, x, positions, kv_lora, rope_theta)
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, params["w_uv"])
    k_full = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(b, s, n_heads, rope_dim)],
        dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(q_full, k_full, v, positions, positions,
                    kv_chunk=kv_chunk)
    y = torch.einsum("bshe,hed->bsd", out.reshape(b, s, n_heads, v_dim),
                     params["w_o"])
    return y, (c_kv, k_rope)


def mla_decode(params, x, cache: MLACache, *, n_heads, kv_lora, nope_dim,
               rope_dim, v_dim, rope_theta=10000.0):
    """Absorbed single-token decode (MQA over the latent cache); the new
    token's latents are written into the cache tensors in place."""
    t = cache.c_kv.shape[1]
    length = _slot(int(cache.length), t)
    pos = _position(length, x.device)
    c_kv, k_rope = _latents(params, x, pos, kv_lora, rope_theta)
    q = torch.einsum("bsd,dhe->bshe", x, params["w_q"])
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    q_rope = apply_rope(q_rope, pos, rope_theta)
    # absorb: q_abs[h, r] = q_nope[h, e] @ w_uk[r, h, e]
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope, params["w_uk"])

    cache.c_kv[:, length] = c_kv[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, length] = k_rope[:, 0].to(cache.k_rope.dtype)

    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    s = (_scores("bqhr,btr->bhqt", q_abs, cache.c_kv)
         + _scores("bqhd,btd->bhqt", q_rope, cache.k_rope)) * scale
    mask = torch.arange(t, device=x.device)[None, None, None, :] <= length
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqt,btr->bqhr", w, cache.c_kv)    # (B,1,H,r)
    out = torch.einsum("bshr,rhe->bshe", ctx, params["w_uv"])
    y = torch.einsum("bshe,hed->bsd", out, params["w_o"])
    return y, MLACache(c_kv=cache.c_kv, k_rope=cache.k_rope,
                       length=length + 1)
