"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, MHA (GQA kv=16), QKV bias."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=2816, vocab=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

REDUCED = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
)

register(FULL, REDUCED)
