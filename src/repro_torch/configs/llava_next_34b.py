"""LLaVA-NeXT-34B [llava-v1.6 family] — dense 34B-class backbone (Yi-34B
shape), GQA kv=8.  The anyres vision tiling is a stub frontend;
input_specs() provides precomputed patch embeddings (input_mode='embeds')."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=20480, vocab=64000,
    input_mode="embeds", rope_theta=5_000_000.0,
)

REDUCED = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv=2, head_dim=8,
    d_ff=128, vocab=512,
    input_mode="embeds", rope_theta=5_000_000.0,
)

register(FULL, REDUCED)
