"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B family] — 128 experts
top-8, GQA kv=4, qk-norm; every layer MoE, no shared experts."""
from .base import ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
    d_ff=1536, vocab=151936,
    qk_norm=True, rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
)

REDUCED = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, head_dim=8,
    d_ff=96, vocab=512,
    qk_norm=True, rope_theta=1_000_000.0,
    # capacity E/k => no token drops (keeps reduced-config decode exactly
    # consistent with prefill; the full config uses the production 1.25)
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                  capacity_factor=4.0),
)

register(FULL, REDUCED)
