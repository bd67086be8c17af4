"""deepseek-v2-lite-16b [moe, arXiv:2405.04434]: 27L, d_model=2048,
16 heads, MLA kv_lora=512 (+64 decoupled-RoPE dims), MoE with 2 shared +
64 routed experts top-6 (the JAX package's config), expert d_ff=1408,
vocab=102400."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102_400,
        mla=True, kv_lora_rank=512, rope_head_dim=64,
        head_dim=128, v_head_dim=128,
        n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="deepseek-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, v_head_dim=32, kv_lora_rank=64,
        rope_head_dim=16, d_ff=128, moe_d_ff=128, n_experts=4, top_k=2,
        n_shared_experts=1, vocab_size=256, attn_chunk=64,
        capacity_factor=4.0)
