"""Attention: GQA/MQA/MHA with RoPE, qk-norm, biases, sliding window, and a
chunked (flash-style) softmax for long sequences.

The chunked path walks the KV blocks with running (max, denom, acc) in fp32
— O(S·chunk) live memory instead of O(S²).  Scores are always computed in
fp32 from the (possibly bf16) q and k, never rounded before the softmax.

Decode writes the new token's K/V into the cache tensors in place (an
indexed write) and returns them.  A write past the cache's end raises
``ValueError``: the JAX package's ``dynamic_update_slice`` clamps the start
instead and overwrites the last slot.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from .layers import Params, apply_rope, init_dense, ones, rms_norm, zeros

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def init_attn(generator, d_model: int, n_heads: int, n_kv: int,
              head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
              dtype=torch.bfloat16):
    p = dict(
        wq=init_dense(generator, d_model, n_heads * head_dim, dtype),
        wk=init_dense(generator, d_model, n_kv * head_dim, dtype),
        wv=init_dense(generator, d_model, n_kv * head_dim, dtype),
        wo=init_dense(generator, n_heads * head_dim, d_model, dtype))
    if qkv_bias:
        p.update(bq=zeros(generator, n_heads * head_dim, dtype),
                 bk=zeros(generator, n_kv * head_dim, dtype),
                 bv=zeros(generator, n_kv * head_dim, dtype))
    if qk_norm:
        p.update(q_norm=ones(generator, head_dim),
                 k_norm=ones(generator, head_dim))
    return Params(**p)


def qkv(params, x, n_heads: int, n_kv: int, head_dim: int,
        positions, rope_theta: float = 10000.0, qk_norm: bool = False):
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv, head_dim)
    v = v.reshape(b, s, n_kv, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _mask(pos_q, pos_k, window: Optional[int]):
    """(Sq, Sk) bool mask: causal, optionally sliding-window."""
    m = pos_q[:, None] >= pos_k[None, :]
    if window is not None:
        m &= (pos_q[:, None] - pos_k[None, :]) < window
    return m


def _scores(eq: str, a, b):
    """fp32 contraction (the reference's ``preferred_element_type``)."""
    return torch.einsum(eq, a.float(), b.float())


def _promoted(eq: str, a, b):
    """Contraction in the promoted dtype of its operands, as jnp's."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def attention(q, k, v, pos_q, pos_k, window: Optional[int] = None,
              kv_chunk: Optional[int] = None):
    """Causal grouped attention.

    q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd); H = KH * G.
    pos_q: (Sq,), pos_k: (Sk,) absolute positions (drive masking).
    Returns (B, Sq, H, hd_v).
    """
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    hd_v = v.shape[-1]          # may differ from hd (MLA)
    g = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, g, hd) * scale

    if kv_chunk is None or sk <= kv_chunk:
        scores = _scores("bqkgd,bskd->bkgqs", qg, k)
        scores = torch.where(_mask(pos_q, pos_k, window)[None, None, None],
                             scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = _promoted("bkgqs,bskd->bqkgd", w, v)
        return out.reshape(b, sq, h, hd_v)

    # ---- chunked online-softmax over KV blocks ----
    assert sk % kv_chunk == 0, "cache length must divide kv_chunk"
    nchunks = sk // kv_chunk
    kc = k.reshape(b, nchunks, kv_chunk, kh, hd)
    vc = v.reshape(b, nchunks, kv_chunk, kh, hd_v)
    pkc = pos_k.reshape(nchunks, kv_chunk)

    m_run = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, hd_v), dtype=torch.float32,
                      device=q.device)
    for c in range(nchunks):
        kb, vb, pb = kc[:, c], vc[:, c], pkc[c]
        s = _scores("bqkgd,bckd->bkgqc", qg, kb)
        s = torch.where(_mask(pos_q, pb, window)[None, None, None], s,
                        NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = _promoted("bkgqc,bckd->bkgqd", p.to(vb.dtype), vb).float()
        acc = acc * alpha[..., None] + pv
        m_run = m_new
    # (b, kh, g, sq, hd_v) -> (b, sq, kh, g, hd_v)
    out = (acc / l_run.clamp(min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, hd_v).to(q.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, T, KH, hd)
    v: torch.Tensor
    length: Union[int, torch.Tensor]   # tokens filled


def init_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    shape = (batch, max_len, n_kv, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def attn_forward(params, x, positions, *, n_heads, n_kv, head_dim,
                 rope_theta=10000.0, qk_norm=False, window=None,
                 kv_chunk=2048):
    """Training / prefill self-attention over a full sequence."""
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim, positions,
                  rope_theta, qk_norm)
    out = attention(q, k, v, positions, positions, window=window,
                    kv_chunk=kv_chunk)
    b, s = x.shape[:2]
    y = out.reshape(b, s, n_heads * head_dim) @ params["wo"]
    return y, (k, v)


def _position(length, device):
    """The decoded token's position as a (1,) tensor, made on the device."""
    return torch.arange(length, length + 1, device=device)


def _slot(length: int, t: int) -> int:
    """The cache slot a decode at ``length`` writes; refuses a full cache
    (the JAX package clamps the write onto the last slot)."""
    if not 0 <= length < t:
        raise ValueError(
            f"decode at length {length} does not fit a cache of {t} "
            "positions")
    return length


def ring_positions(length, t: int, device=None):
    """Absolute position held by each slot of a ring buffer of size t after
    writing token ``length`` at slot ``length % t``: the largest p <= length
    with p ≡ slot (mod t); unwritten slots get INT32_MAX so the causal mask
    removes them."""
    i = torch.arange(t, device=device)
    p = int(length) - (int(length) - i) % t
    return torch.where(p < 0, INT32_MAX, p)


def attn_decode_ring(params, x, k_cache, v_cache, length, *, n_heads, n_kv,
                     head_dim, rope_theta=10000.0, qk_norm=False,
                     window: Optional[int] = None):
    """Single-token decode against a bounded ring-buffer cache (sliding-
    window attention; caches stay O(window) for long decodes).

    k_cache/v_cache: (B, t, KH, hd) with t = min(max_len, window), written
    in place.  Degenerates to the linear cache when length < t.
    """
    b = x.shape[0]
    length = int(length)
    pos = _position(length, x.device)
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim, pos,
                  rope_theta, qk_norm)
    t = k_cache.shape[1]
    slot = length % t
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    pos_k = ring_positions(length, t, x.device)
    out = attention(q, k_cache, v_cache, pos, pos_k, window=window,
                    kv_chunk=None)
    y = out.reshape(b, 1, n_heads * head_dim) @ params["wo"]
    return y, k_cache, v_cache


def quantize_kv(k):
    """Per-(token,head) max-abs int8 quantization of a KV tensor
    (..., head_dim).  Returns (int8 values, bf16 scales)."""
    kf = k.float()
    amax = kf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None].float()).to(dtype)


def attn_decode_quant(params, x, k_q, v_q, k_s, v_s, length, *, n_heads,
                      n_kv, head_dim, rope_theta=10000.0, qk_norm=False,
                      window=None):
    """Single-token decode against an int8-quantized KV cache.

    k_q/v_q: (B, T, KH, hd) int8; k_s/v_s: (B, T, KH) bf16 scales; all four
    are written in place.
    """
    b = x.shape[0]
    t = k_q.shape[1]
    length = _slot(int(length), t)
    pos = _position(length, x.device)
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim, pos,
                  rope_theta, qk_norm)
    k_i8, k_sc = quantize_kv(k)
    v_i8, v_sc = quantize_kv(v)
    k_q[:, length] = k_i8[:, 0]
    v_q[:, length] = v_i8[:, 0]
    k_s[:, length] = k_sc[:, 0]
    v_s[:, length] = v_sc[:, 0]
    out = attention(q, dequantize_kv(k_q, k_s), dequantize_kv(v_q, v_s),
                    pos, torch.arange(t, device=x.device), window=window,
                    kv_chunk=None)
    y = out.reshape(b, 1, n_heads * head_dim) @ params["wo"]
    return y, (k_q, v_q, k_s, v_s)


def attn_decode(params, x, cache: KVCache, *, n_heads, n_kv, head_dim,
                rope_theta=10000.0, qk_norm=False, window=None):
    """Single-token decode against a KV cache.

    x: (B, 1, D); cache holds max_len positions, cache.length are filled;
    the new token's K/V are written into cache.k / cache.v in place.
    """
    b = x.shape[0]
    t = cache.k.shape[1]
    length = _slot(int(cache.length), t)
    pos = _position(length, x.device)
    q, k, v = qkv(params, x, n_heads, n_kv, head_dim, pos,
                  rope_theta, qk_norm)
    cache.k[:, length] = k[:, 0].to(cache.k.dtype)
    cache.v[:, length] = v[:, 0].to(cache.v.dtype)
    out = attention(q, cache.k, cache.v, pos,
                    torch.arange(t, device=x.device), window=window,
                    kv_chunk=None)
    y = out.reshape(b, 1, n_heads * head_dim) @ params["wo"]
    return y, KVCache(k=cache.k, v=cache.v, length=length + 1)
