"""llama-3.2-vision-90b [vlm, hf:meta-llama/Llama-3.2-11B-Vision]:
100L (80 self + 20 gated cross-attn, every 5th), d_model=8192, 64 heads,
GQA kv=8, d_ff=28672, vocab=128256. The ViT and projector are
stubbed: the batch's ``patches`` input is (B, 1601, d_model) patch
embeddings."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28_672, vocab_size=128_256,
        pos_emb="rope", rope_theta=5e5, norm="rmsnorm", act="silu",
        cross_attn_every=5, n_patches=1601,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="llama-vision-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=256, cross_attn_every=2,
        n_patches=16, attn_chunk=64)
