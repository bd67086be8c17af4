"""stablelm-1.6b [dense, hf:stabilityai/stablelm-2-1_6b]: 24L,
d_model=2048, 32 heads MHA (kv=32), d_ff=5632, vocab=100352,
partial RoPE (25%), LayerNorm."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab_size=100_352,
        pos_emb="rope", rope_pct=0.25, norm="layernorm",
        act="silu", mlp_gated=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="stablelm-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=256, attn_chunk=64)
