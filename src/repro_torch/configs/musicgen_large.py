"""MusicGen-Large [arXiv:2306.05284] — decoder-only over EnCodec tokens.
Backbone only: the EnCodec frontend is a stub; input_specs() provides
precomputed frame embeddings (input_mode='embeds')."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=8192, vocab=2048,
    input_mode="embeds", rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=128,
    input_mode="embeds", rope_theta=10000.0,
)

register(FULL, REDUCED)
