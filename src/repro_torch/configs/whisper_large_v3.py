"""whisper-large-v3 [audio, arXiv:2212.04356]: 32L enc + 32L dec,
d_model=1280, 20 heads (MHA; GQA kv=20), d_ff=5120, vocab=51866.
The conv/mel frontend is stubbed: the batch's ``frames`` input, (B, 1500,
d_model) frame embeddings, feeds the encoder."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32,
        d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51_866,
        pos_emb="learned", norm="layernorm", act="gelu", mlp_gated=False,
        attn_bias=True, mlp_bias=True, tie_embeddings=True,
        n_frames=1500, max_position=1 << 16,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="whisper-smoke", n_layers=2, n_enc_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=256, n_frames=16,
        attn_chunk=64, max_position=4096)
