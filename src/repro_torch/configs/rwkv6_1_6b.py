"""RWKV6-1.6B "Finch" [arXiv:2404.05892] — attention-free, data-dependent
decay; O(1) state => runs the 500k long-context decode shape."""
from .base import ModelConfig, register

FULL = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, head_dim=64,
    d_ff=7168, vocab=65536,
    supports_long_context=True,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    supports_long_context=True,
)

register(FULL, REDUCED)
