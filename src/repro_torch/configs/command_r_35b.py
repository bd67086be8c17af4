"""command-r-35b [dense, hf:CohereForAI/c4ai-command-r-v01]: 40L,
d_model=8192, 64 heads, GQA kv=8, d_ff=22528, vocab=256000, no biases,
parallel attention+MLP block, tied embeddings."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22_528, vocab_size=256_000,
        pos_emb="rope", rope_theta=8e6, norm="layernorm",
        act="silu", mlp_gated=True, parallel_block=True,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="command-r-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=256, attn_chunk=64)
