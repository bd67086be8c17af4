"""The paper's 150M Chinchilla-style transformer (Table 1): 12L,
hidden 896, 16 heads, K/V size 64, vocab 32000."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="diloco-150m", family="dense",
        n_layers=12, d_model=896, n_heads=16, n_kv_heads=16,
        head_dim=64, d_ff=3584, vocab_size=32_000,
        pos_emb="rope", norm="rmsnorm", act="silu", mlp_gated=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="diloco-150m-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=256,
        attn_chunk=64)
