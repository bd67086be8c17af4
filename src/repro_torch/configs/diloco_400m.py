"""The paper's 400M Chinchilla-style transformer (Table 1): 12L,
hidden 1536, 12 heads, K/V size 128, vocab 32000."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="diloco-400m", family="dense",
        n_layers=12, d_model=1536, n_heads=12, n_kv_heads=12,
        head_dim=128, d_ff=6144, vocab_size=32_000,
        pos_emb="rope", norm="rmsnorm", act="silu", mlp_gated=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="diloco-400m-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab_size=256,
        attn_chunk=64)
