"""Gemma-2B [arXiv:2403.08295] — GeGLU, head_dim=256, MQA (kv=1),
(1+g) RMSNorm, sqrt(d) embedding scaling, tied embeddings."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, head_dim=256,
    d_ff=16384, vocab=256000,
    activation="gelu", norm_offset=1.0, embed_scale=True,
    tie_embeddings=True, rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, head_dim=32,
    d_ff=256, vocab=512,
    activation="gelu", norm_offset=1.0, embed_scale=True,
    tie_embeddings=True, rope_theta=10000.0,
)

register(FULL, REDUCED)
