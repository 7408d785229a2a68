"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent decay, plus the squared-ReLU channel-mix.

State per layer: the WKV matrix S (B, H, N, N) in fp32, the previous token
for the time-mix shift, and the previous token for the channel-mix shift —
O(1) in sequence length, which is why this arch (not full attention) runs
the 500k-token decode shape.

``time_mix`` runs the recurrence as a Python loop over time (the
recurrent form, the JAX package's ``lax.scan`` step in its order); the
chunked block-parallel form ``_wkv_chunked`` takes over when
``CHUNKED_WKV`` is set and T is a multiple of ``WKV_CHUNK``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import Params, _device, init_dense, normal, ones, zeros

LORA_MIX = 32     # low-rank size of the data-dependent mixing MLP
LORA_DECAY = 64   # low-rank size of the data-dependent decay MLP

# The chunked block-parallel WKV6 — the same transform as Mamba2's SSD
# (models/mamba2.py).  The recurrent loop streams the (B,H,N,N) state every
# token; chunking crosses the loop once per WKV_CHUNK steps and computes
# intra-chunk interactions as masked contractions in log-decay space
# (per-channel decays, so the decay kernel is materialized per
# (t,s,channel) — (K,K,N) per head-chunk).
CHUNKED_WKV = False
WKV_CHUNK = 16


def init_time_mix(generator, d: int, n_heads: int, dtype=torch.bfloat16):
    hd = d // n_heads
    dev = _device(generator)
    ramp = torch.arange(d, dtype=torch.float32, device=dev) / max(1, d - 1)
    return Params(
        maa_x=zeros(generator, d, dtype),
        maa_rkvwg=torch.zeros((5, d), dtype=dtype, device=dev),
        maa_w1=init_dense(generator, d, 5 * LORA_MIX, dtype, scale=1e-4),
        maa_w2=normal(generator, (5, LORA_MIX, d), LORA_MIX ** -0.5, dtype),
        decay_base=-6.0 + 5.0 * ramp ** 0.9,
        decay_w1=init_dense(generator, d, LORA_DECAY, dtype, scale=1e-4),
        decay_w2=init_dense(generator, LORA_DECAY, d, dtype, scale=1e-4),
        bonus=torch.zeros((n_heads, hd), dtype=torch.float32,
                          device=dev),                      # u
        wr=init_dense(generator, d, d, dtype),
        wk=init_dense(generator, d, d, dtype),
        wv=init_dense(generator, d, d, dtype),
        wg=init_dense(generator, d, d, dtype),
        wo=init_dense(generator, d, d, dtype),
        ln_x=ones(generator, d))                            # group norm


def init_channel_mix(generator, d: int, d_ff: int, dtype=torch.bfloat16):
    return Params(
        maa_k=zeros(generator, d, dtype),
        maa_r=zeros(generator, d, dtype),
        wk=init_dense(generator, d, d_ff, dtype),
        wv=init_dense(generator, d_ff, d, dtype),
        wr=init_dense(generator, d, d, dtype))


def _shifted(x, x_prev):
    """The token shift: (B, T, D) with x_prev (B, D) in front."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix_inputs(p, x, x_prev):
    """Data-dependent token-shift interpolation (the Finch novelty).

    x: (B, T, D); x_prev: (B, D) token before the window.
    Returns 5 mixed streams (r, k, v, w, g) each (B, T, D).
    """
    xx = _shifted(x, x_prev) - x
    xxx = x + xx * p["maa_x"]
    mixed = torch.tanh(xxx @ p["maa_w1"])                   # (B,T,5*L)
    b, t, _ = mixed.shape
    mixed = mixed.reshape(b, t, 5, LORA_MIX)
    deltas = torch.einsum("btfl,fld->fbtd", mixed, p["maa_w2"])
    return [x + xx * (p["maa_rkvwg"][f] + deltas[f]) for f in range(5)]


def _decay(p, xw):
    """Per-channel data-dependent decay w in (0,1): exp(-exp(base+lora))."""
    lora = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    return torch.exp(-torch.exp(p["decay_base"] + lora.float()))


def _group_norm(x, scale, n_heads, eps=1e-5):
    b, t, d = x.shape
    xg = x.reshape(b, t, n_heads, d // n_heads).float()
    mu = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(b, t, d) * scale).to(x.dtype)


def _wkv_chunked(r, k, v, w, u, S0):
    """Block-parallel WKV6: exact chunked form of the recurrence

        S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
        y_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)

    Per chunk, in log-decay space (decays are per key-channel, so the
    intra-chunk kernel sums over channels with the exp inside):
        G[t,s] = Σ_i r_ti k_si e^{L_{t-1,i} - L_{s,i}}   (s < t)
        G[t,t] = (r_t ⊙ u) · k_t                         (bonus)
        y = G @ v + (r_t ⊙ e^{L_{t-1}}) · S_carry
    All exponents are ≤ 0 (decays < 1), so no overflow.
    r/k/v/w: (B,T,H,N) fp32; u: (H,N); S0: (B,H,N,N).
    """
    b, t, h, n = r.shape
    kk = WKV_CHUNK
    mask_lt = torch.tril(torch.ones((kk, kk), dtype=torch.bool,
                                    device=r.device), -1)
    S, ys = S0, []
    for c in range(t // kk):
        rc, kc, vc, wc = (a[:, c * kk:(c + 1) * kk] for a in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=1e-38))
        L = torch.cumsum(logw, dim=1)
        Lp = L - logw                                       # L_{t-1}
        diff = Lp[:, :, None] - L[:, None]                  # (B,K,K,H,N)
        dk = torch.where(mask_lt[None, :, :, None, None], torch.exp(diff),
                         0.0)
        G = torch.einsum("bthn,bshn,btshn->btsh", rc, kc, dk)
        Gdiag = torch.einsum("bthn,hn,bthn->bth", rc, u, kc)
        y = torch.einsum("btsh,bshn->bthn", G, vc) + Gdiag[..., None] * vc
        y = y + torch.einsum("bthi,bhij->bthj", rc * torch.exp(Lp), S)
        wend = torch.exp(L[:, -1][:, None] - L)             # e^{L_K - L_s}
        S = torch.exp(L[:, -1])[..., None] * S + torch.einsum(
            "bshn,bshm->bhnm", kc * wend, vc)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _wkv_recurrent(r, k, v, w, u, S):
    """The recurrence one token at a time; r/k/v/w (B,T,H,N) fp32."""
    ys = []
    for i in range(r.shape[1]):
        r_t, k_t, v_t, w_t = r[:, i], k[:, i], v[:, i], w[:, i]  # (B,H,N)
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B,H,N,N)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t, S + u[..., None] * kv))
        S = w_t[..., None] * S + kv
    return torch.stack(ys, dim=1), S


def time_mix(p, x, x_prev, S, n_heads: int):
    """WKV6 over a window.  x: (B,T,D); S: (B,H,N,N) fp32 state.
    Returns (y, new_x_prev, new_S); new_x_prev is a view of x."""
    b, t, d = x.shape
    n = d // n_heads
    xr, xk, xv, xw, xg = _mix_inputs(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(b, t, n_heads, n).float()
    k = (xk @ p["wk"]).reshape(b, t, n_heads, n).float()
    v = (xv @ p["wv"]).reshape(b, t, n_heads, n).float()
    g = F.silu((xg @ p["wg"]).float())
    w = _decay(p, xw).reshape(b, t, n_heads, n)             # (B,T,H,N)
    u = p["bonus"]                                          # (H,N)

    if CHUNKED_WKV and t % WKV_CHUNK == 0 and t > 1:
        ys, S_new = _wkv_chunked(r, k, v, w, u, S)
    else:
        ys, S_new = _wkv_recurrent(r, k, v, w, u, S)
    wkv = ys.reshape(b, t, d).to(x.dtype)
    out = _group_norm(wkv, p["ln_x"], n_heads)
    y = (out * g.to(out.dtype)) @ p["wo"]
    return y.to(x.dtype), x[:, -1], S_new


def channel_mix(p, x, x_prev):
    """Squared-ReLU channel mix; returns (y, new_x_prev), the latter a view
    of x."""
    xx = _shifted(x, x_prev) - x
    xk = x + xx * p["maa_k"]
    xr = x + xx * p["maa_r"]
    k = torch.square(torch.relu((xk @ p["wk"]).float()))
    kv = k.to(x.dtype) @ p["wv"]
    return torch.sigmoid((xr @ p["wr"]).float()).to(x.dtype) * kv, x[:, -1]


class RWKVLayerState(NamedTuple):
    tm_x: torch.Tensor    # (B, D) last token seen by time-mix
    cm_x: torch.Tensor    # (B, D) last token seen by channel-mix
    S: torch.Tensor       # (B, H, N, N) fp32 WKV state


def init_state(batch: int, d: int, n_heads: int, dtype=torch.bfloat16,
               device=None) -> RWKVLayerState:
    n = d // n_heads
    return RWKVLayerState(
        tm_x=torch.zeros((batch, d), dtype=dtype, device=device),
        cm_x=torch.zeros((batch, d), dtype=dtype, device=device),
        S=torch.zeros((batch, n_heads, n, n), dtype=torch.float32,
                      device=device))
