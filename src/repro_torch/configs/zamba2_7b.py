"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + weight-shared attention
block applied every `hybrid_period` layers with per-application LoRA.
Attention uses a sliding window in long-context mode => bounded decode state
=> runs the 500k shape."""
from .base import ModelConfig, SSMConfig, register

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_inner=7168, d_state=64, head_dim=64),
    hybrid_period=6, shared_lora_rank=128,
    long_context_window=4096, supports_long_context=True,
)

REDUCED = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=7, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    ssm=SSMConfig(d_inner=128, d_state=16, head_dim=32),
    hybrid_period=3, shared_lora_rank=8,
    long_context_window=64, supports_long_context=True,
)

register(FULL, REDUCED)
