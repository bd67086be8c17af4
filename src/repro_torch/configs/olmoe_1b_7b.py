"""olmoe-1b-7b [moe, arXiv:2409.02060]: 16L, d_model=2048, 16 heads
(kv=16), 64 experts top-8 (no shared), expert d_ff=1024, vocab=50304,
qk-norm."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50_304,
        n_experts=64, top_k=8, moe_d_ff=1024,
        qk_norm=True, norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="olmoe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=128, moe_d_ff=128, n_experts=4, top_k=2,
        vocab_size=256, attn_chunk=64, capacity_factor=4.0)
