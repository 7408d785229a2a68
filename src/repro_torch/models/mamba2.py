"""Mamba2 (SSD) block — the state-space component of Zamba2 hybrids.

h_t = exp(A·dt_t)·h_{t-1} + dt_t·(x_t ⊗ B_t);   y_t = h_t·C_t + D·x_t

with per-head scalar A (negative), data-dependent dt (softplus), a width-4
causal conv on the (x,B,C) stream, and gated output.  State per layer:
(B, heads, head_dim, d_state) fp32 + conv tail (B, conv-1, conv_dim) —
O(1) in sequence length, enabling the 500k decode shape.

``mamba2_forward`` runs the recurrence as a Python loop over time (the
recurrent form, the JAX package's ``lax.scan`` step in its order); the
chunked block-parallel SSD ``_ssd_chunked`` takes over when
``CHUNKED_SSD`` is set and T is a multiple of ``SSD_CHUNK``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import Params, _device, init_dense, normal, ones, rms_norm, zeros

CONV_W = 4

# The block-parallel SSD form (Mamba2's own chunked algorithm).  The
# recurrent loop streams the (B,H,P,N) state every timestep; chunking
# crosses the loop once per SSD_CHUNK steps and turns intra-chunk work into
# masked contractions.  Default off: the recurrent form is the
# paper-faithful baseline.
CHUNKED_SSD = False
SSD_CHUNK = 16


def _ssd_chunked(xs, B, C, dt, a, h0):
    """Block-parallel SSD (Mamba2 Alg. 1, single B/C group).

    xs: (Bt, T, H, P); B/C: (Bt, T, N); dt: (Bt, T, H) softplus'd;
    a: (H,) negative; h0: (Bt, H, P, N) fp32.
    Returns y (Bt, T, H, P) fp32, h_final.

    Within a chunk:  log-decay L_t = Σ_{s<=t} a·dt_s;
      y_t = C_t·(e^{L_t} h0) + Σ_{s<=t} e^{L_t - L_s} dt_s (C_t·B_s) x_s
      h_end = e^{L_K} h0 + Σ_s e^{L_K - L_s} dt_s (x_s ⊗ B_s)
    The inner sum is a causal-masked (K×K) contraction per head instead of
    K sequential state updates.
    """
    bt, t, h, p = xs.shape
    n = B.shape[-1]
    k = SSD_CHUNK
    nc = t // k

    xs = xs.float().reshape(bt, nc, k, h, p)
    Bc = B.float().reshape(bt, nc, k, n)
    Cc = C.float().reshape(bt, nc, k, n)
    dtc = dt.float().reshape(bt, nc, k, h)

    # per-chunk log-decays
    la = a[None, None, None, :] * dtc                   # (Bt,nc,K,H)
    L = torch.cumsum(la, dim=2)                         # L_t inclusive
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)        # (Bt,nc,K,K)
    # G[t,s] = e^{L_t - L_s} dt_s (C_t·B_s) for s<=t
    diff = L[:, :, :, None, :] - L[:, :, None, :, :]    # (Bt,nc,K,K,H)
    mask = torch.tril(torch.ones((k, k), dtype=torch.bool, device=xs.device))
    G = torch.where(mask[None, None, :, :, None], torch.exp(diff), 0.0) \
        * dtc[:, :, None, :, :] * cb[..., None]         # (Bt,nc,K,K,H)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", G, xs)

    # inter-chunk: carry h through the chunk ends
    ed = torch.exp(L)                                   # e^{L_t}
    w_end = torch.exp(L[:, :, -1:, :] - L) * dtc        # (Bt,nc,K,H)
    dxb = torch.einsum("bcsh,bcshp,bcsn->bchpn", w_end, xs, Bc)
    la_sum = L[:, :, -1, :]                             # (Bt,nc,H)
    hc, y_h0 = h0, []
    for c in range(nc):
        y_h0.append(torch.einsum("bth,btn,bhpn->bthp", ed[:, c], Cc[:, c],
                                 hc))
        hc = torch.exp(la_sum[:, c])[..., None, None] * hc + dxb[:, c]
    y = y_intra + torch.stack(y_h0, dim=1)
    return y.reshape(bt, t, h, p), hc


def init_mamba2(generator, d_model: int, d_inner: int, d_state: int,
                head_dim: int = 64, dtype=torch.bfloat16):
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    dev = _device(generator)
    return Params(
        # z (gate), xBC (conv stream), dt (heads)
        w_in=init_dense(generator, d_model, d_inner + conv_dim + n_heads,
                        dtype),
        conv_w=normal(generator, (CONV_W, conv_dim), CONV_W ** -0.5, dtype),
        conv_b=zeros(generator, conv_dim, dtype),
        a_log=torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                     device=dev)),
        dt_bias=torch.full((n_heads,), math.log(math.e - 1),
                           dtype=torch.float32, device=dev),
        d_skip=ones(generator, n_heads),
        out_norm=ones(generator, d_inner),
        w_out=init_dense(generator, d_inner, d_model, dtype))


class Mamba2State(NamedTuple):
    h: torch.Tensor         # (B, H, P, N) fp32 SSM state
    conv: torch.Tensor      # (B, CONV_W-1, conv_dim) conv tail


def init_state(batch: int, d_inner: int, d_state: int, head_dim: int = 64,
               dtype=torch.bfloat16, device=None) -> Mamba2State:
    n_heads = d_inner // head_dim
    return Mamba2State(
        h=torch.zeros((batch, n_heads, head_dim, d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_W - 1, d_inner + 2 * d_state),
                         dtype=dtype, device=device))


def _split(p, x, d_inner: int, d_state: int, n_heads: int):
    zxbcdt = x @ p["w_in"]
    conv_dim = d_inner + 2 * d_state
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def _conv(p, xbc, conv_state):
    """Causal depthwise conv width 4; conv_state holds the previous CONV_W-1
    inputs.  Each tap's product and the sum are in fp32: the JAX package
    writes the product in the compute dtype, but its compiled form keeps it
    in fp32 (ROADMAP C35), and this form equals that bit for bit.
    Returns (activated stream, new tail)."""
    full = torch.cat([conv_state, xbc], dim=1)          # (B, T+3, C)
    t = xbc.shape[1]
    acc = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for w in range(CONV_W):
        acc = acc + full[:, w:w + t].float() * p["conv_w"][w].float()
    acc = acc + p["conv_b"].float()
    return F.silu(acc).to(xbc.dtype), full[:, -(CONV_W - 1):]


def _ssd_recurrent(xs, B, C, dt, a, h):
    """The recurrence one step at a time; xs (B,T,H,P), B/C (B,T,N),
    dt (B,T,H), all fp32."""
    ys = []
    for i in range(xs.shape[1]):
        x_t, b_t, c_t, dt_t = xs[:, i], B[:, i], C[:, i], dt[:, i]
        decay = torch.exp(a * dt_t)                     # (B,H)
        dbx = (dt_t[..., None] * x_t)[..., None] * b_t[:, None, None, :]
        h = decay[..., None, None] * h + dbx
        ys.append(torch.einsum("bhpn,bn->bhp", h, c_t))
    return torch.stack(ys, dim=1), h


def mamba2_forward(p, x, state: Mamba2State, *, d_inner: int, d_state: int,
                   head_dim: int = 64):
    """x: (B, T, D) -> (y, new_state); the new conv tail is a view of the
    conv input."""
    b, t, _ = x.shape
    n_heads = d_inner // head_dim
    z, xbc, dt = _split(p, x, d_inner, d_state, n_heads)
    xbc, conv_tail = _conv(p, xbc, state.conv)
    xs = xbc[..., :d_inner].reshape(b, t, n_heads, head_dim)
    B = xbc[..., d_inner:d_inner + d_state]              # (B,T,N) group=1
    C = xbc[..., d_inner + d_state:]
    dt = F.softplus(dt.float() + p["dt_bias"])           # (B,T,H)
    a = -torch.exp(p["a_log"])                           # (H,) negative

    if CHUNKED_SSD and t % SSD_CHUNK == 0 and t > 1:
        y, h_new = _ssd_chunked(xs, B, C, dt, a, state.h)
    else:
        y, h_new = _ssd_recurrent(xs.float(), B.float(), C.float(), dt, a,
                                  state.h)
    y = y + p["d_skip"][:, None] * xs.float()
    y = y.reshape(b, t, d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    y = rms_norm(y, p["out_norm"])
    return y @ p["w_out"], Mamba2State(h=h_new, conv=conv_tail)
