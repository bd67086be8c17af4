"""qwen3-32b [dense, hf:Qwen/Qwen3-8B family]: 64L, d_model=5120,
64 heads (head_dim=128), GQA kv=8, d_ff=25600, vocab=151936, qk-norm."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=25_600, vocab_size=151_936,
        pos_emb="rope", rope_theta=1e6, qk_norm=True,
        norm="rmsnorm", act="silu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen3-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256,
        attn_chunk=64)
