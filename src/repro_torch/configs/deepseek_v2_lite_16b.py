"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] — MLA (kv_lora=512) + MoE
64 routed experts top-6 + 2 shared experts; first layer dense.
(The assignment line's "160 routed" is the V2-236B config; we follow the
primary "MoE 64e top-6" spec — see DESIGN.md §7.)"""
from .base import ModelConfig, MoEConfig, MLAConfig, register

FULL = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, head_dim=192,
    d_ff=10944, vocab=102400,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora=512, nope_dim=128, rope_dim=64, v_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, d_ff_shared=2816, first_dense=1),
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv=4, head_dim=24,
    d_ff=160, vocab=512,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora=32, nope_dim=16, rope_dim=8, v_dim=16),
    # capacity E/k => no token drops in the reduced config (see qwen3-moe)
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64,
                  num_shared=2, d_ff_shared=128, first_dense=1,
                  capacity_factor=4.0),
)

register(FULL, REDUCED)
