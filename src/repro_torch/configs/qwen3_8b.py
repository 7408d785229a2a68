"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk-norm."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=12288, vocab=151936,
    qk_norm=True, rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
    qk_norm=True, rope_theta=1_000_000.0,
)

register(FULL, REDUCED)
