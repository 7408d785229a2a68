"""LM assembly for the dense family (dense / audio / vlm / moe).

  model = build_model(cfg, device="cuda", generator=g)   # an nn.Module
  logits = model.forward(inputs)                          # (B, S, V)
  loss, metrics = model.loss(batch)
  state = model.init_decode_state(batch, max_len)
  state, logits = model.decode_step(state, inputs_1)      # one token
  state, logits = model.prefill(inputs, max_len)

``inputs`` is token ids (B, S) for input_mode='tokens', or precomputed
frontend embeddings (B, S, D) for 'embeds' (audio/vlm stubs).

The JAX package stacks the layers on a leading axis and scans them; here
``first_layers`` and ``layers`` are ``nn.ModuleList``s of blocks (the
stacks unstacked) walked by a Python loop.  The decode state keeps the
reference's stacked layout — ``{"scan": {"k", "v"[, "ks", "vs"]},
["first": {...}], "length"}`` with caches shaped (L, B, T, ...) — so states
compare array for array; decode writes each layer's slice in place.
``length`` is a 0-d int32 tensor kept on the host, so a decode reads it
without waiting for the card.  Prefill and decode run under
``torch.inference_mode()``.

The recurrent families (``RWKVLM``, ``HybridLM``) are not ported yet
(ROADMAP A17b): ``build_model`` refuses them.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from . import attention as A
from . import mla as MLA
from . import moe as MOE
from .layers import (cross_entropy_loss, init_dense, init_embed, init_mlp,
                     mlp, ones, rms_norm)


def _norm(cfg, x, scale):
    return rms_norm(x, scale, offset=cfg.norm_offset)


def _zero_aux(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance_loss": z, "dropped_fraction": z}


# ===========================================================================
# Dense-family block (attention = GQA or MLA; FFN = MLP or MoE)
# ===========================================================================

class Block(nn.Module):
    """One layer's weights: ``ln1``, ``ln2``, ``attn`` or ``mla``, ``mlp``
    or ``moe`` — the reference's block dict."""

    def __init__(self, cfg: ModelConfig, generator, use_moe: bool):
        super().__init__()
        dt = cfg.compute_dtype
        self.ln1 = nn.Parameter(ones(generator, cfg.d_model),
                                requires_grad=False)
        self.ln2 = nn.Parameter(ones(generator, cfg.d_model),
                                requires_grad=False)
        if cfg.mla is not None:
            c = cfg.mla
            self.mla = MLA.init_mla(generator, cfg.d_model, cfg.n_heads,
                                    c.kv_lora, c.nope_dim, c.rope_dim,
                                    c.v_dim, dt)
        else:
            self.attn = A.init_attn(generator, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv, cfg.head_dim, cfg.qkv_bias,
                                    cfg.qk_norm, dt)
        if use_moe:
            m = cfg.moe
            self.moe = MOE.init_moe(generator, cfg.d_model, m.d_ff_expert,
                                    m.num_experts, m.num_shared,
                                    m.d_ff_shared, dt)
        else:
            self.mlp = init_mlp(generator, cfg.d_model, cfg.d_ff, dt)


def block_attn_forward(cfg, p, x, positions, kv_chunk, window):
    h = _norm(cfg, x, p.ln1)
    if cfg.mla is not None:
        c = cfg.mla
        y, kv = MLA.mla_forward(
            p.mla, h, positions, n_heads=cfg.n_heads, kv_lora=c.kv_lora,
            nope_dim=c.nope_dim, rope_dim=c.rope_dim, v_dim=c.v_dim,
            rope_theta=cfg.rope_theta, kv_chunk=kv_chunk)
    else:
        y, kv = A.attn_forward(
            p.attn, h, positions, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, window=window, kv_chunk=kv_chunk)
    return x + y, kv


def block_ffn_forward(cfg, p, x, use_moe: bool):
    h = _norm(cfg, x, p.ln2)
    if use_moe:
        m = cfg.moe
        y, aux = MOE.moe_forward(
            p.moe, h, num_experts=m.num_experts, top_k=m.top_k,
            capacity_factor=m.capacity_factor)
    else:
        y = mlp(p.mlp, h, cfg.activation)
        aux = _zero_aux(x.device)
    return x + y, aux


def block_attn_decode(cfg, p, x, kcache, vcache, length: int, window):
    """Single-token decode; writes the caches in place."""
    h = _norm(cfg, x, p.ln1)
    if cfg.mla is not None:
        c = cfg.mla
        cache = MLA.MLACache(c_kv=kcache, k_rope=vcache, length=length)
        y, _ = MLA.mla_decode(
            p.mla, h, cache, n_heads=cfg.n_heads, kv_lora=c.kv_lora,
            nope_dim=c.nope_dim, rope_dim=c.rope_dim, v_dim=c.v_dim,
            rope_theta=cfg.rope_theta)
        return x + y
    cache = A.KVCache(k=kcache, v=vcache, length=length)
    y, _ = A.attn_decode(
        p.attn, h, cache, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, window=window)
    return x + y


class DenseLM(nn.Module):
    """dense / audio / vlm / moe families (GQA or MLA attention)."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # "meta" builds the weights' names and shapes without memory
        # (convert.lm_state_dict_from_jax checks a tree against them)
        dev = torch.device("meta") if str(device) == "meta" \
            else resolve(device)
        if generator is None:
            generator = torch.Generator(
                device="cpu" if dev.type == "meta" else dev).manual_seed(0)
        elif dev.type != "meta" and generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{dev}")
        self.cfg = cfg
        self.device = dev
        m = cfg.moe
        self.n_first_dense = m.first_dense if m else 0
        self.n_scanned = cfg.n_layers - self.n_first_dense
        self.use_moe = m is not None
        with torch.device(dev):
            self._init_weights(generator)

    def _init_weights(self, g):
        cfg, dt = self.cfg, self.cfg.compute_dtype

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        if cfg.input_mode == "tokens":
            self.embed = param(init_embed(g, cfg.vocab, cfg.d_model, dt))
            if not cfg.tie_embeddings:
                self.head = param(init_dense(g, cfg.d_model, cfg.vocab, dt))
        else:
            self.head = param(init_dense(g, cfg.d_model, cfg.vocab, dt))
        self.final_norm = param(ones(g, cfg.d_model))
        self.first_layers = nn.ModuleList(  # empty unless moe.first_dense
            Block(cfg, g, use_moe=False) for _ in range(self.n_first_dense))
        self.layers = nn.ModuleList(
            Block(cfg, g, use_moe=self.use_moe)
            for _ in range(self.n_scanned))

    # ---- embedding / head ----
    def embed_in(self, inputs):
        cfg = self.cfg
        if cfg.input_mode == "tokens":
            x = torch.nn.functional.embedding(inputs, self.embed)
            if cfg.embed_scale:
                # sqrt(d_model) rounded to the activation dtype first
                x = x * float(torch.tensor(cfg.d_model ** 0.5,
                                           dtype=x.dtype))
            return x
        return inputs.to(cfg.compute_dtype)

    def head_out(self, x):
        cfg = self.cfg
        x = _norm(cfg, x, self.final_norm)
        if cfg.input_mode == "tokens" and cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.head

    # ---- full-sequence forward (train / prefill math) ----
    def forward(self, inputs, return_kv: bool = False,
                return_aux: bool = False, window: Optional[int] = None,
                logits_mode: str = "all"):
        cfg = self.cfg
        x = self.embed_in(inputs)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        kv_chunk = 2048 if s > 2048 else None
        window = window if window is not None else cfg.sliding_window

        first_kv = []
        for lp in self.first_layers:
            x, kv = block_attn_forward(cfg, lp, x, positions, kv_chunk,
                                       window)
            x, _ = block_ffn_forward(cfg, lp, x, use_moe=False)
            first_kv.append(kv)

        ks, vs, auxs = [], [], []
        for lp in self.layers:
            x, (k, v) = block_attn_forward(cfg, lp, x, positions, kv_chunk,
                                           window)
            x, aux = block_ffn_forward(cfg, lp, x, use_moe=self.use_moe)
            if return_kv:
                ks.append(k)
                vs.append(v)
            auxs.append(aux)
        if logits_mode == "last":
            x = x[:, -1:]        # serving prefill: last-token logits only
        logits = self.head_out(x)
        out = (logits,)
        if return_kv:
            out += ((first_kv, (torch.stack(ks), torch.stack(vs))),)
        if return_aux:      # the mean over the scanned layers
            out += ({name: torch.stack([a[name] for a in auxs]).mean()
                     for name in auxs[0]},)
        return out if len(out) > 1 else logits

    def loss(self, batch):
        logits, aux = self.forward(batch["inputs"], return_aux=True)
        ce = cross_entropy_loss(logits, batch["targets"])
        total = ce
        metrics = {"ce": ce}
        if self.use_moe:
            total = total + 0.01 * aux["load_balance_loss"]
            metrics.update(aux)
        return total, metrics

    # ---- decode ----
    @property
    def _kv_int8(self):
        return (self.cfg.kv_cache_dtype == "int8"
                and self.cfg.mla is None)

    def init_decode_state(self, batch: int, max_len: int):
        cfg = self.cfg
        dt = cfg.compute_dtype

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def mk(n):
            if cfg.mla is not None:
                c = cfg.mla
                return {"k": zeros((n, batch, max_len, c.kv_lora), dt),
                        "v": zeros((n, batch, max_len, c.rope_dim), dt)}
            kv = (n, batch, max_len, cfg.n_kv, cfg.head_dim)
            if self._kv_int8:
                return {"k": zeros(kv, torch.int8),
                        "v": zeros(kv, torch.int8),
                        "ks": zeros(kv[:-1], torch.bfloat16),
                        "vs": zeros(kv[:-1], torch.bfloat16)}
            return {"k": zeros(kv, dt), "v": zeros(kv, dt)}

        state = {"scan": mk(self.n_scanned),
                 "length": torch.zeros((), dtype=torch.int32)}
        if self.n_first_dense:
            state["first"] = mk(self.n_first_dense)
        return state

    @torch.inference_mode()
    def decode_step(self, state, inputs):
        """One token for every sequence of the batch: the caches in
        ``state`` are written in place; returns (new state, logits)."""
        cfg = self.cfg
        x = self.embed_in(inputs)                    # (B, 1, D)
        length = int(state["length"])
        window = cfg.sliding_window

        for i, lp in enumerate(self.first_layers):
            x = block_attn_decode(cfg, lp, x, state["first"]["k"][i],
                                  state["first"]["v"][i], length, window)
            x, _ = block_ffn_forward(cfg, lp, x, use_moe=False)

        sc = state["scan"]
        for i, lp in enumerate(self.layers):
            if self._kv_int8:
                h = _norm(cfg, x, lp.ln1)
                y, _ = A.attn_decode_quant(
                    lp.attn, h, sc["k"][i], sc["v"][i], sc["ks"][i],
                    sc["vs"][i], length, n_heads=cfg.n_heads,
                    n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
                    window=window)
                x = x + y
            else:
                x = block_attn_decode(cfg, lp, x, sc["k"][i], sc["v"][i],
                                      length, window)
            x, _ = block_ffn_forward(cfg, lp, x, use_moe=self.use_moe)
        logits = self.head_out(x)
        new_state = dict(state)
        new_state["length"] = torch.tensor(length + 1, dtype=torch.int32)
        return new_state, logits

    @torch.inference_mode()
    def prefill(self, inputs, max_len: Optional[int] = None):
        """Full-sequence pass that also fills the decode caches."""
        b, s = inputs.shape[:2]
        max_len = max_len or s
        if s > max_len:
            raise ValueError(f"a prompt of {s} tokens does not fit a cache "
                             f"of {max_len} positions")
        logits, (first_kv, kvs) = self.forward(inputs, return_kv=True,
                                               logits_mode="last")
        state = self.init_decode_state(b, max_len)

        def fill_group(group, k_new, v_new):
            if self._kv_int8:
                k_new, k_sc = A.quantize_kv(k_new)
                v_new, v_sc = A.quantize_kv(v_new)
                group["ks"][:, :, :s] = k_sc
                group["vs"][:, :, :s] = v_sc
            group["k"][:, :, :s] = k_new
            group["v"][:, :, :s] = v_new

        fill_group(state["scan"], *kvs)
        if self.n_first_dense:
            fill_group(state["first"],
                       torch.stack([kv[0] for kv in first_kv]),
                       torch.stack([kv[1] for kv in first_kv]))
        state["length"] = torch.tensor(s, dtype=torch.int32)
        return state, logits


# ===========================================================================

def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> DenseLM:
    if cfg.family in ("dense", "audio", "vlm", "moe"):
        return DenseLM(cfg, device=device, generator=generator)
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (RWKVLM / HybridLM) is "
            "not ported yet (ROADMAP A17b)")
    raise ValueError(f"unknown family {cfg.family!r}")
