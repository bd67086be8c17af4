"""zamba2-2.7b [hybrid, arXiv:2411.15242]: 54 Mamba2 layers
(d_state=64) + one SHARED attention+MLP block invoked every 6 layers
(9 invocations, tied weights), d_model=2560, 32 heads (kv=32),
d_ff=10240, vocab=32000."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10_240, vocab_size=32_000,
        ssm_state=64, ssm_expand=2, ssm_heads=80, ssm_chunk=256,
        shared_attn_every=6, pos_emb="rope", norm="layernorm", act="gelu",
        mlp_gated=False,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="zamba2-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab_size=256, ssm_state=16,
        ssm_heads=4, ssm_chunk=32, shared_attn_every=2, attn_chunk=64)
