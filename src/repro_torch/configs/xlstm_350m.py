"""xlstm-350m [ssm, arXiv:2405.04517]: 24 blocks, d_model=1024,
4 heads, d_ff=0 (gated projections inside the cells), vocab=50304,
3 mLSTM blocks per 1 sLSTM block."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50_304,
        slstm_every=4, pos_emb="none", norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="xlstm-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, vocab_size=256, slstm_every=2)
