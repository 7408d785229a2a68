"""Model configuration dataclasses + the architecture registry.

Every assigned architecture registers a ``ModelConfig`` here via its own
module (one file per arch, imported by ``registry()``), with a FULL config
(the published widths) and a REDUCED one (family-preserving, small, for the
CPU tests).  The values are the JAX package's, copied: the port imports
nothing of it.  Configs are shapes only; nothing here fetches weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared (always-on) experts
    d_ff_shared: int = 0
    first_dense: int = 0         # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int = 0             # 0 -> 2 * d_model
    d_state: int = 64
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    # options
    qkv_bias: bool = False
    qk_norm: bool = False
    activation: str = "silu"     # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    norm_offset: float = 0.0     # gemma: 1.0 ((1+g) RMSNorm)
    embed_scale: bool = False    # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    # long-context mode (hybrids): window used by attention blocks when the
    # cache would otherwise be unbounded
    long_context_window: int = 4096
    input_mode: str = "tokens"   # tokens | embeds (audio/vlm stub frontend)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 6       # zamba2: shared attn every k ssm layers
    shared_lora_rank: int = 64
    dtype: str = "bfloat16"
    # decode KV cache dtype: bfloat16 | int8 (per-(token,head) max-abs
    # scales; §Perf cell C bandwidth-compression lever)
    kv_cache_dtype: str = "bfloat16"
    # which input shapes this arch supports (decode needs a bounded state)
    supports_long_context: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS in §Roofline)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.input_mode == "embeds":
            emb = v * d  # head only (frontend stubbed)
        if self.family == "ssm":
            # rwkv6: time-mix 5 square mats + channel-mix
            tm = 5 * d * d + d * (5 * 32) + 5 * 32 * d + d * 64 + 64 * d
            cm = 2 * d * self.d_ff + d * d
            return emb + L * (tm + cm)
        per_layer = 0
        if self.family == "hybrid":
            s = self.ssm or SSMConfig()
            d_inner = s.d_inner or 2 * d
            conv_dim = d_inner + 2 * s.d_state
            nh = d_inner // s.head_dim
            m = d * (d_inner + conv_dim + nh) + d_inner * d
            per_layer = m
            shared = (d * 3 * self.n_heads * self.head_dim
                      + self.n_heads * self.head_dim * d
                      + 3 * d * self.d_ff)
            n_shared_apps = self.n_layers // self.hybrid_period
            return emb + L * per_layer + shared + n_shared_apps * (
                4 * d * self.shared_lora_rank * 2)
        # attention
        if self.mla is not None:
            c = self.mla
            attn = (d * (c.kv_lora + c.rope_dim)
                    + c.kv_lora * self.n_heads * (c.nope_dim + c.v_dim)
                    + d * self.n_heads * (c.nope_dim + c.rope_dim)
                    + self.n_heads * c.v_dim * d)
        else:
            attn = d * self.head_dim * (self.n_heads * 2 + self.n_kv * 2)
        # mlp / moe
        if self.moe is not None:
            m = self.moe
            moe_l = (d * m.num_experts
                     + 3 * d * m.d_ff_expert * m.num_experts
                     + (3 * d * m.d_ff_shared if m.num_shared else 0))
            dense_l = 3 * d * self.d_ff
            n_moe = L - m.first_dense
            return emb + L * attn + n_moe * moe_l + m.first_dense * dense_l
        return emb + L * (attn + 3 * d * self.d_ff)

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts top_k + shared experts."""
        if self.moe is None:
            return self.param_count()
        d, L, m = self.d_model, self.n_layers, self.moe
        total = self.param_count()
        n_moe = L - m.first_dense
        all_experts = 3 * d * m.d_ff_expert * m.num_experts
        active = 3 * d * m.d_ff_expert * m.top_k
        return total - n_moe * (all_experts - active)


_REGISTRY = {}


def register(cfg: ModelConfig, reduced: ModelConfig):
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def registry():
    """Import all arch modules and return {name: (full, reduced)}."""
    from . import (qwen1_5_0_5b, gemma_2b, granite_3_2b, qwen3_8b,  # noqa
                   rwkv6_1_6b, musicgen_large, zamba2_7b,
                   qwen3_moe_235b_a22b, deepseek_v2_lite_16b,
                   llava_next_34b)
    return dict(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")
    return reg[name][1 if reduced else 0]
