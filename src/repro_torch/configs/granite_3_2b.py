"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base] — dense, GQA kv=8."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv=8, head_dim=64,
    d_ff=8192, vocab=49155,
    tie_embeddings=True, rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, head_dim=8,
    d_ff=128, vocab=512,
    tie_embeddings=True, rope_theta=10000.0,
)

register(FULL, REDUCED)
