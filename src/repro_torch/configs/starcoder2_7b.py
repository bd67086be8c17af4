"""starcoder2-7b [dense, arXiv:2402.19173]: 32L, d_model=4608, 36 heads,
GQA kv=4, d_ff=18432, vocab=49152, RoPE, biased non-gated GELU MLP."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
        d_ff=18_432, vocab_size=49_152,
        pos_emb="rope", rope_theta=1e5, norm="layernorm",
        act="gelu", mlp_gated=False, attn_bias=True, mlp_bias=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="starcoder2-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=256, attn_chunk=64)
