"""LM assembly for every family of the repo: ``DenseLM`` (dense / audio /
vlm / moe), ``RWKVLM`` (ssm: RWKV6) and ``HybridLM`` (hybrid: Mamba2 and
a weight-shared attention block).

  model = build_model(cfg, device="cuda", generator=g)   # an nn.Module
  logits = model.forward(inputs)                          # (B, S, V)
  loss, metrics = model.loss(batch)
  state = model.init_decode_state(batch, max_len)
  state, logits = model.decode_step(state, inputs_1)      # one token
  state, logits = model.prefill(inputs, max_len)

``inputs`` is token ids (B, S) for input_mode='tokens', or precomputed
frontend embeddings (B, S, D) for 'embeds' (audio/vlm stubs).

The JAX package stacks the layers on a leading axis and scans them; here
the stacks are ``nn.ModuleList``s of per-layer modules (``first_layers``,
``layers``; the hybrid's ``mamba_groups`` a list of lists) walked by a
Python loop.  The decode states keep the reference's stacked layouts —
``DenseLM``'s ``{"scan": {"k", "v"[, "ks", "vs"]}, ["first": {...}],
"length"}`` with caches shaped (L, B, T, ...), the recurrent families'
NamedTuples of stacked tensors (see their classes) — so states compare
array for array; decode writes each layer's slice in place.  ``length``
is a 0-d int32 tensor kept on the host, so a decode reads it without
waiting for the card.  Prefill and decode run under
``torch.inference_mode()``.

The module's weights are frozen parameters.  Training evaluates
``model.loss`` on other tensors through :func:`call_with`
(``train/step.py`` passes views of the params tree in the reference's
stacked layout); ``model.remat`` (``none``, ``full``, ``dots``) then
checkpoints each scanned layer, or each hybrid group with the shared
block, as the reference's ``_maybe_remat`` does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from . import attention as A
from . import mamba2 as M2
from . import mla as MLA
from . import moe as MOE
from . import rwkv6 as R6
from .layers import (Params, cross_entropy_loss, init_dense, init_embed,
                     init_mlp, layer_norm, mlp, ones, rms_norm, zeros)


def _norm(cfg, x, scale):
    return rms_norm(x, scale, offset=cfg.norm_offset)


def call_with(model: nn.Module, weights, fn, *args):
    """``fn(*args)`` with the model's weights named in ``weights`` (state
    dict keys -> tensors) standing in for its own for the call
    (``torch.func.functional_call``); the rest stay as they are.  The
    training path evaluates ``model.loss`` so, on the tensors it
    differentiates, while the module's own weights stay frozen."""
    return torch.func.functional_call(
        _Call(model), {f"model.{k}": w for k, w in weights.items()},
        (fn,) + args)


class _Call(nn.Module):
    """``functional_call``'s target: calls ``fn(*args)`` while the wrapped
    model's weights are replaced."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(*args)


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the output of a
    matmul without batch dimensions, recompute everything else (a
    ``bmm`` has one: attention scores and MoE experts are recomputed)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# the reference's _maybe_remat policies -> torch.utils.checkpoint's options
REMAT = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_saveable)},
}


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


class _LM(nn.Module):
    """What every family shares: the device, the generator the weights are
    drawn from, the embedding and head and the final norm."""

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
        self.remat = "none"        # set by train.step.make_train_step
        self._setup()
        with torch.device(dev):
            self._init_embed_head(generator)
            self._init_weights(generator)

    def _setup(self):
        """Derived sizes, before any weight is drawn."""

    def _init_weights(self, g):
        raise NotImplementedError

    def _remat(self, fn, x, *prefixes):
        """``fn(x)``, one layer or one hybrid group whose weights are the
        submodules at ``prefixes``, under the reference's activation
        checkpointing (``self.remat``: ``none``, ``full`` or ``dots``,
        applied while grad is enabled).  The weights enter the checkpoint
        as arguments and are put back in place for the call, so the
        backward's recomputation reads the tensors the forward read."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn(x)
        if self.remat not in REMAT:
            raise ValueError(f"unknown remat policy {self.remat!r}")
        names, weights = [], []
        for prefix in prefixes:
            for name, w in self.get_submodule(prefix).named_parameters(
                    prefix=prefix):
                names.append(name)
                weights.append(w)

        def body(x, *ws):
            return call_with(self, dict(zip(names, ws)), fn, x)

        return checkpoint(body, x, *weights, use_reentrant=False,
                          **REMAT[self.remat])

    def _init_embed_head(self, g):
        cfg, dt = self.cfg, self.cfg.compute_dtype
        if cfg.input_mode == "tokens":
            self.embed = _param(init_embed(g, cfg.vocab, cfg.d_model, dt))
            if not cfg.tie_embeddings:
                self.head = _param(init_dense(g, cfg.d_model, cfg.vocab, dt))
        else:
            self.head = _param(init_dense(g, cfg.d_model, cfg.vocab, dt))
        self.final_norm = _param(ones(g, cfg.d_model))

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

    def loss(self, batch):
        logits = self.forward(batch["inputs"])
        ce = cross_entropy_loss(logits, batch["targets"])
        return ce, {"ce": ce}


def _param(t):
    return nn.Parameter(t, requires_grad=False)


class DenseLM(_LM):
    """dense / audio / vlm / moe families (GQA or MLA attention)."""

    def _setup(self):
        m = self.cfg.moe
        self.n_first_dense = m.first_dense if m else 0
        self.n_scanned = self.cfg.n_layers - self.n_first_dense
        self.use_moe = m is not None

    def _init_weights(self, g):
        cfg = self.cfg
        self.first_layers = nn.ModuleList(  # empty unless moe.first_dense
            Block(cfg, g, use_moe=False) for _ in range(self.n_first_dense))
        self.layers = nn.ModuleList(
            Block(cfg, g, use_moe=self.use_moe)
            for _ in range(self.n_scanned))

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

        def body(lp, x):
            x, kv = block_attn_forward(cfg, lp, x, positions, kv_chunk,
                                       window)
            x, aux = block_ffn_forward(cfg, lp, x, use_moe=self.use_moe)
            return x, kv, aux

        ks, vs, auxs = [], [], []
        for i, lp in enumerate(self.layers):
            x, (k, v), aux = self._remat(functools.partial(body, lp), x,
                                         f"layers.{i}")
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
# RWKV6 (ssm family)
# ===========================================================================

def _rwkv_layer(cfg: ModelConfig, g) -> Params:
    """One layer's weights: the reference's layer dict (``ln1``/``ln1_b``,
    ``ln2``/``ln2_b``, ``tm``, ``cm``)."""
    return Params(
        ln1=ones(g, cfg.d_model), ln1_b=zeros(g, cfg.d_model, torch.float32),
        ln2=ones(g, cfg.d_model), ln2_b=zeros(g, cfg.d_model, torch.float32),
        tm=R6.init_time_mix(g, cfg.d_model, cfg.n_heads, cfg.compute_dtype),
        cm=R6.init_channel_mix(g, cfg.d_model, cfg.d_ff,
                               cfg.compute_dtype))


def _stack_states(states, cls):
    """A list of per-layer NamedTuple states -> one of stacked tensors."""
    return cls(*(torch.stack(parts) for parts in zip(*states)))


def _layer_state(stacked, idx):
    """The state at ``idx`` of a NamedTuple of stacked tensors (views)."""
    return type(stacked)(*(a[idx] for a in stacked))


def _write_layer_state(stacked, idx, new):
    """Write one layer's new state into its slice of ``stacked``."""
    for dst, src in zip(stacked, new):
        dst[idx].copy_(src)


class RWKVLM(_LM):
    """RWKV6: ``ln0`` after the embedding, then ``layers`` of time-mix and
    channel-mix, each behind a LayerNorm.

    The decode state is ``{"states": RWKVLayerState(tm_x (L,B,D), cm_x
    (L,B,D), S (L,B,H,N,N) fp32), "length"}``, the reference's stacked
    layout; ``decode_step`` writes each layer's slice in place."""

    def _init_weights(self, g):
        cfg = self.cfg
        self.ln0 = _param(ones(g, cfg.d_model))
        self.ln0_b = _param(zeros(g, cfg.d_model, torch.float32))
        self.layers = nn.ModuleList(_rwkv_layer(cfg, g)
                                    for _ in range(cfg.n_layers))

    def _zero_state(self, batch):
        cfg = self.cfg
        return R6.init_state(batch, cfg.d_model, cfg.n_heads,
                             cfg.compute_dtype, device=self.device)

    def _block(self, lp, x, st):
        h = layer_norm(x, lp.ln1, lp.ln1_b)
        y, tm_x, S = R6.time_mix(lp.tm, h, st.tm_x, st.S, self.cfg.n_heads)
        x = x + y
        h = layer_norm(x, lp.ln2, lp.ln2_b)
        y, cm_x = R6.channel_mix(lp.cm, h, st.cm_x)
        return x + y, R6.RWKVLayerState(tm_x=tm_x, cm_x=cm_x, S=S)

    def _run(self, inputs):
        """Every layer from a zero state; returns x and the stacked new
        states."""
        x = layer_norm(self.embed_in(inputs), self.ln0, self.ln0_b)
        zero = self._zero_state(x.shape[0])
        states = []
        for i, lp in enumerate(self.layers):
            x, st = self._remat(
                lambda x, lp=lp: self._block(lp, x, zero), x, f"layers.{i}")
            states.append(st)
        return x, _stack_states(states, R6.RWKVLayerState)

    def forward(self, inputs):
        return self.head_out(self._run(inputs)[0])

    def init_decode_state(self, batch: int, max_len: int = 0):
        L = self.cfg.n_layers
        st = self._zero_state(batch)
        return {"states": R6.RWKVLayerState(
                    *(a.new_zeros((L,) + a.shape) for a in st)),
                "length": torch.zeros((), dtype=torch.int32)}

    @torch.inference_mode()
    def decode_step(self, state, inputs):
        """One token for every sequence of the batch: the states in
        ``state`` are written in place; returns (new state, logits)."""
        x = layer_norm(self.embed_in(inputs), self.ln0, self.ln0_b)
        sts = state["states"]
        for i, lp in enumerate(self.layers):
            x, new = self._block(lp, x, _layer_state(sts, i))
            _write_layer_state(sts, i, new)
        new_state = dict(state)
        new_state["length"] = torch.tensor(int(state["length"]) + 1,
                                           dtype=torch.int32)
        return new_state, self.head_out(x)

    @torch.inference_mode()
    def prefill(self, inputs, max_len: Optional[int] = None):
        """The prompt through every layer; the decode state holds each
        layer's last state (O(1) in the prompt's length)."""
        x, states = self._run(inputs)
        logits = self.head_out(x[:, -1:])
        return ({"states": states,
                 "length": torch.tensor(inputs.shape[1], dtype=torch.int32)},
                logits)


# ===========================================================================
# Zamba2-style hybrid: Mamba2 stack + weight-shared attention block
# ===========================================================================

def _mamba_layer(cfg: ModelConfig, d_inner: int, g) -> Params:
    s = cfg.ssm
    return Params(ln=ones(g, cfg.d_model),
                  m=M2.init_mamba2(g, cfg.d_model, d_inner, s.d_state,
                                   s.head_dim, cfg.compute_dtype))


def _lora(cfg: ModelConfig, g) -> Params:
    """Per-application LoRA on the shared block's qkv input proj."""
    r, dt = cfg.shared_lora_rank, cfg.compute_dtype
    return Params(lora_a=init_dense(g, cfg.d_model, r, dt, scale=1e-4),
                  lora_b=init_dense(g, r, cfg.d_model, dt))


class HybridLM(_LM):
    """n_layers Mamba2 blocks; after every `hybrid_period` of them the
    weight-shared attention+MLP block runs with a per-application LoRA
    delta on its input (the Zamba2 mechanism, simplified as the JAX
    package does).

    ``mamba_groups`` is an ``nn.ModuleList`` of ``n_groups`` lists of
    ``period`` layers, ``mamba_tail`` the layers after the last group,
    ``shared`` the attention + MLP block and ``lora`` one LoRA per
    application.  The decode state is the reference's stacked layout:
    ``{"groups": Mamba2State(h (G,P,B,H,hd,N) fp32, conv
    (G,P,B,3,conv_dim)), "tail": Mamba2State or None, "k"/"v"
    (G,B,t,KH,hd), "length"}`` with a ring of t = min(max_len,
    long_context_window) positions when ``supports_long_context``;
    ``decode_step`` writes every state and the ring in place.

    As in the reference, ``forward`` (and so ``prefill``) attends with
    ``cfg.sliding_window`` while ``decode_step`` attends over the ring
    with ``long_context_window`` (ROADMAP C33)."""

    def _setup(self):
        cfg = self.cfg
        self.period = cfg.hybrid_period
        self.n_groups = cfg.n_layers // self.period
        self.n_tail = cfg.n_layers - self.n_groups * self.period
        self.d_inner = cfg.ssm.d_inner or 2 * cfg.d_model

    def _init_weights(self, g):
        cfg, dt = self.cfg, self.cfg.compute_dtype
        self.mamba_groups = nn.ModuleList(
            nn.ModuleList(_mamba_layer(cfg, self.d_inner, g)
                          for _ in range(self.period))
            for _ in range(self.n_groups))
        self.mamba_tail = nn.ModuleList(        # empty when n_tail is 0
            _mamba_layer(cfg, self.d_inner, g) for _ in range(self.n_tail))
        self.shared = Params(
            ln1=ones(g, cfg.d_model), ln2=ones(g, cfg.d_model),
            attn=A.init_attn(g, cfg.d_model, cfg.n_heads, cfg.n_kv,
                             cfg.head_dim, dtype=dt),
            mlp=init_mlp(g, cfg.d_model, cfg.d_ff, dt))
        self.lora = nn.ModuleList(_lora(cfg, g)
                                  for _ in range(self.n_groups))

    def _mamba_block(self, lp, x, st):
        cfg = self.cfg
        h = _norm(cfg, x, lp.ln)
        y, new_st = M2.mamba2_forward(
            lp.m, h, st, d_inner=self.d_inner, d_state=cfg.ssm.d_state,
            head_dim=cfg.ssm.head_dim)
        return x + y, new_st

    def _shared_in(self, lora, x):
        """The shared block's normed input plus this application's LoRA."""
        h = _norm(self.cfg, x, self.shared.ln1)
        return h + (h @ lora.lora_a) @ lora.lora_b

    def _shared_mlp(self, x):
        sp = self.shared
        return x + mlp(sp.mlp, _norm(self.cfg, x, sp.ln2),
                       self.cfg.activation)

    def _shared_block_forward(self, lora, x, positions, window, kv_chunk):
        """The shared attention + MLP block over a whole sequence; returns
        (x, (k, v))."""
        cfg = self.cfg
        y, kv = A.attn_forward(
            self.shared.attn, self._shared_in(lora, x), positions,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=window, kv_chunk=kv_chunk)
        return self._shared_mlp(x + y), kv

    def _zero_mamba_state(self, batch):
        cfg = self.cfg
        return M2.init_state(batch, self.d_inner, cfg.ssm.d_state,
                             cfg.ssm.head_dim, cfg.compute_dtype,
                             device=self.device)

    def forward(self, inputs, window: Optional[int] = None,
                return_state: bool = False, logits_mode: str = "all"):
        cfg = self.cfg
        x = self.embed_in(inputs)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        kv_chunk = 2048 if s > 2048 else None
        window = window if window is not None else cfg.sliding_window
        zero = self._zero_mamba_state(x.shape[0])

        def group(glp, lora, x):
            sts = []
            for lp in glp:
                x, st = self._mamba_block(lp, x, zero)
                sts.append(st)
            x, kv = self._shared_block_forward(lora, x, positions, window,
                                               kv_chunk)
            return x, sts, kv

        gstates, ks, vs = [], [], []
        for gi, (glp, lora) in enumerate(zip(self.mamba_groups, self.lora)):
            x, sts, (k, v) = self._remat(
                functools.partial(group, glp, lora), x,
                f"mamba_groups.{gi}", "shared", f"lora.{gi}")
            gstates += sts
            ks.append(k)
            vs.append(v)
        tstates = []
        for lp in self.mamba_tail:
            x, st = self._mamba_block(lp, x, zero)
            tstates.append(st)
        if logits_mode == "last":
            x = x[:, -1:]
        logits = self.head_out(x)
        if not return_state:
            return logits
        groups = _stack_states(gstates, M2.Mamba2State)
        groups = M2.Mamba2State(*(a.reshape(
            (self.n_groups, self.period) + a.shape[1:]) for a in groups))
        tail = _stack_states(tstates, M2.Mamba2State) if tstates else None
        return logits, (groups, tail, (torch.stack(ks), torch.stack(vs)))

    def init_decode_state(self, batch: int, max_len: int):
        cfg = self.cfg
        # long-context mode: attention cache bounded by the sliding window
        t = min(max_len, cfg.long_context_window) \
            if cfg.supports_long_context else max_len
        st = self._zero_mamba_state(batch)
        kv = torch.zeros((self.n_groups, batch, t, cfg.n_kv, cfg.head_dim),
                         dtype=cfg.compute_dtype, device=self.device)
        return {
            "groups": M2.Mamba2State(*(a.new_zeros(
                (self.n_groups, self.period) + a.shape) for a in st)),
            "tail": (M2.Mamba2State(*(a.new_zeros((self.n_tail,) + a.shape)
                                      for a in st))
                     if self.n_tail else None),
            "k": kv, "v": torch.zeros_like(kv),
            "length": torch.zeros((), dtype=torch.int32),
        }

    def _mamba_decode(self, lp, x, states, idx):
        """One Mamba2 block on the state at ``idx`` of the stacked
        ``states``, written back in place."""
        x, new = self._mamba_block(lp, x, _layer_state(states, idx))
        _write_layer_state(states, idx, new)
        return x

    @torch.inference_mode()
    def decode_step(self, state, inputs):
        """One token for every sequence of the batch: the Mamba2 states and
        the ring caches in ``state`` are written in place; returns (new
        state, logits)."""
        cfg = self.cfg
        x = self.embed_in(inputs)
        length = int(state["length"])
        window = cfg.long_context_window if cfg.supports_long_context \
            else None
        for gi, (glp, lora) in enumerate(zip(self.mamba_groups, self.lora)):
            for pi, lp in enumerate(glp):
                x = self._mamba_decode(lp, x, state["groups"], (gi, pi))
            y, _, _ = A.attn_decode_ring(
                self.shared.attn, self._shared_in(lora, x), state["k"][gi],
                state["v"][gi], length, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                window=window)
            x = self._shared_mlp(x + y)
        for i, lp in enumerate(self.mamba_tail):
            x = self._mamba_decode(lp, x, state["tail"], i)
        new_state = dict(state)
        new_state["length"] = torch.tensor(length + 1, dtype=torch.int32)
        return new_state, self.head_out(x)

    @torch.inference_mode()
    def prefill(self, inputs, max_len: Optional[int] = None):
        """Full-sequence pass that also fills the decode state.  A prompt
        of s >= t tokens leaves the ring holding its last t keys: slot i
        the largest position p < s with p ≡ i (mod t)."""
        b, s = inputs.shape[:2]
        max_len = max_len or s
        logits, (groups, tail, (k_new, v_new)) = self.forward(
            inputs, return_state=True, logits_mode="last")
        state = self.init_decode_state(b, max_len)
        state["groups"], state["tail"] = groups, tail
        t = state["k"].shape[2]
        if s >= t:
            i = torch.arange(t, device=k_new.device)
            pos_idx = (s - 1) - torch.remainder(s - 1 - i, t)
            state["k"] = k_new[:, :, pos_idx].to(state["k"].dtype)
            state["v"] = v_new[:, :, pos_idx].to(state["v"].dtype)
        else:
            state["k"][:, :, :s] = k_new
            state["v"][:, :, :s] = v_new
        state["length"] = torch.tensor(s, dtype=torch.int32)
        return state, logits


# ===========================================================================

def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> _LM:
    if cfg.family in ("dense", "audio", "vlm", "moe"):
        return DenseLM(cfg, device=device, generator=generator)
    if cfg.family == "ssm":
        return RWKVLM(cfg, device=device, generator=generator)
    if cfg.family == "hybrid":
        return HybridLM(cfg, device=device, generator=generator)
    raise ValueError(f"unknown family {cfg.family!r}")
