"""Mixture-of-Experts with sort-based capacity dispatch.

Dispatch is the sparse step: the (tokens × experts) routing matrix is a
structurally *asymmetric* sparse matrix, and dispatch/combine are SpMM with
it.  As in the JAX package, tokens are sorted (stably) by expert id,
positions within an expert come from a running count, and overflow beyond
the capacity is dropped, so every buffer has a static shape.  The combine
sums each token's k weighted outputs by one reduction in token-major order
where the reference's ``segment_sum`` scatters them (ROADMAP C32).

``moe_forward`` is the global dispatch; ``moe_forward_hierarchical`` the
two-stage form that sorts within groups of the batch (capacity per group).
The JAX package's ``CONSTRAIN_DISPATCH`` switch between them, and its
``"constrain"`` mode (sharding constraints), are placements across chips
with no meaning on one device: the port calls each function by name.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import Params, init_dense, init_mlp, mlp, normal

DISPATCH_GROUPS = 16        # the data-axis size the groups align with


def init_moe(generator, d_model: int, d_ff_expert: int, num_experts: int,
             num_shared: int = 0, d_ff_shared: int = 0,
             dtype=torch.bfloat16):
    def expert_weights(fan_in, shape):
        return normal(generator, shape, fan_in ** -0.5, dtype)

    p = dict(
        router=init_dense(generator, d_model, num_experts, torch.float32),
        w_gate=expert_weights(d_model, (num_experts, d_model, d_ff_expert)),
        w_up=expert_weights(d_model, (num_experts, d_model, d_ff_expert)),
        w_down=expert_weights(d_ff_expert,
                              (num_experts, d_ff_expert, d_model)))
    if num_shared:
        p["shared"] = init_mlp(generator, d_model, d_ff_shared, dtype)
    return Params(**p)


def _route(params, xf, top_k: int, router_normalize: bool):
    """fp32 softmax router, top-k and gate renormalization."""
    logits = xf.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)                   # (..., E)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)
    if router_normalize:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
    return probs, gate_vals, expert_idx


def _dispatch(xf, expert_idx, gate_vals, num_experts: int, top_k: int,
              capacity: int):
    """Sort one group's (token, choice) pairs by expert and pack the kept
    ones into an (E, C, D) buffer; returns the buffer and the metadata the
    combine needs."""
    t, d = xf.shape
    flat_e = expert_idx.reshape(-1)                         # (T*k,)
    flat_g = gate_vals.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    sorted_tok = order // top_k
    sorted_g = flat_g[order]
    # position within expert: index - start offset of that expert
    counts = torch.bincount(sorted_e, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * top_k, device=xf.device) - starts[sorted_e]
    keep = pos < capacity
    pos_c = pos.clamp(max=capacity - 1)
    buf = torch.zeros((num_experts, capacity, d), dtype=xf.dtype,
                      device=xf.device)
    src = torch.where(keep[:, None], xf[sorted_tok], 0).to(xf.dtype)
    buf.index_put_((sorted_e, pos_c), src, accumulate=True)
    return buf, (order, sorted_e, sorted_g, keep, pos_c)


def _experts(params, buf):
    """Batched GLU MLP over the expert axis: (E, N, D) -> (E, N, D)."""
    h_gate = torch.bmm(buf, params["w_gate"])
    h_up = torch.bmm(buf, params["w_up"])
    h = F.silu(h_gate.float()).to(buf.dtype) * h_up
    return torch.bmm(h, params["w_down"])


def _combine(out_buf, meta, t: int):
    """Gather each kept pair's expert output, weight it by its gate and
    sum per token: the pairs go back to token-major order and each token's
    k are summed by one reduction, in a fixed order (``index_add_`` on the
    card adds in atomic order, so greedy decoding would not repeat)."""
    order, sorted_e, sorted_g, keep, pos_c = meta
    gathered = out_buf[sorted_e, pos_c]                     # (T*k, D)
    contrib = torch.where(keep[:, None], gathered, 0) * \
        sorted_g[:, None].to(out_buf.dtype)
    by_token = torch.empty_like(contrib)
    by_token[order] = contrib                               # a permutation
    return by_token.reshape(t, -1, contrib.shape[-1]).sum(dim=1)


def _aux(probs, expert_idx, keep, num_experts: int, top_k: int):
    """Switch aux load-balance loss E · Σ_e f_e · p_e and the dropped
    fraction of (token, choice) pairs."""
    t = probs.numel() // num_experts
    me = probs.reshape(t, num_experts).mean(dim=0)
    fe = torch.bincount(expert_idx.reshape(-1), minlength=num_experts) / (
        t * top_k)
    return {"load_balance_loss": num_experts * torch.sum(fe * me),
            "dropped_fraction": 1.0 - keep.float().mean()}


def moe_forward(params, x, *, num_experts: int, top_k: int,
                capacity_factor: float = 1.25,
                router_normalize: bool = True) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (B, S, D), aux metrics (load-balance loss etc.)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs, gate_vals, expert_idx = _route(params, xf, top_k,
                                          router_normalize)
    capacity = max(1, int(t * top_k / num_experts * capacity_factor))
    buf, meta = _dispatch(xf, expert_idx, gate_vals, num_experts, top_k,
                          capacity)
    y = _combine(_experts(params, buf), meta, t)
    if "shared" in params:
        y = y + mlp(params["shared"], xf).reshape(t, d)
    return y.reshape(b, s, d), _aux(probs, expert_idx, meta[3],
                                    num_experts, top_k)


def moe_forward_hierarchical(params, x, *, num_experts: int, top_k: int,
                             capacity_factor: float = 1.25,
                             router_normalize: bool = True
                             ) -> Tuple[torch.Tensor, dict]:
    """Two-stage dispatch: the batch is split into G groups (at most
    ``DISPATCH_GROUPS``, tiling the batch exactly); each group sorts and
    capacity-packs its own tokens into (E, C, D), the experts run once over
    the (E, G·C, D) expert-major buffer, and each group combines its own.
    Equal to ``moe_forward`` up to which tokens are dropped at tight
    capacity (capacity is per group here)."""
    b, s, d = x.shape
    t = b * s
    g = min(DISPATCH_GROUPS, b)
    while b % g:                 # groups must tile the batch exactly
        g -= 1
    tg = t // g
    xg = x.reshape(g, tg, d)
    probs, gate_vals, expert_idx = _route(params, xg, top_k,
                                          router_normalize)
    capacity = max(1, int(tg * top_k / num_experts * capacity_factor))
    bufs, metas = zip(*(_dispatch(xg[i], expert_idx[i], gate_vals[i],
                                  num_experts, top_k, capacity)
                        for i in range(g)))
    # batch-major (G, E, C, D) -> expert-major (E, G·C, D)
    buf_e = torch.stack(bufs, dim=1).reshape(num_experts, g * capacity, d)
    out_e = _experts(params, buf_e).reshape(num_experts, g, capacity, d)
    y = torch.stack([_combine(out_e[:, i], metas[i], tg)
                     for i in range(g)]).reshape(t, d)
    if "shared" in params:
        y = y + mlp(params["shared"], x.reshape(t, d)).reshape(t, d)
    keep = torch.cat([m[3] for m in metas])
    return y.reshape(b, s, d), _aux(probs, expert_idx, keep, num_experts,
                                    top_k)
