"""The dense variants (``stablelm_1_6b``: LayerNorm, partial RoPE;
``starcoder2_7b``: attention and MLP biases, GELU; ``qwen3_32b``:
qk-norm; ``command_r_35b``: the parallel block, tied embeddings) against
the JAX package at smoke width, from JAX params whose zero and one leaves
are perturbed (``families_common``): the new layer pieces, loss and
gradients, prefill and decode, one k=2, H=2 DiLoCo round; then the
port's paged engine against its contiguous one, bit for bit, for every
config the engine serves but those of their own family files.

Tolerances: f32, atol 1e-5, rtol 1e-4 (logits, losses, caches, states;
the matmuls reduce in another order), gradients atol 1e-6, rtol 1e-4;
tokens and positions exactly."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import families_common as FC  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)
DENSE = ["stablelm_1_6b", "starcoder2_7b", "qwen3_32b", "command_r_35b"]


def test_rms_head_norm_and_sincos_positions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    FC.close(TL.rms_head_norm(torch.from_numpy(scale), torch.from_numpy(x)),
             JL.rms_head_norm(jnp.asarray(scale), jnp.asarray(x)),
             "rms_head_norm", 1e-5, 1e-6)
    FC.close(TL.sincos_positions(37, 64, device="cpu"),
             JL.sincos_positions(37, 64), "sincos", 1e-6, 1e-6)


@pytest.mark.parametrize("name", ["starcoder2_7b", "qwen3_32b"])
def test_attention_and_mlp_layers_match_jax(name):
    """One attention layer (biases or qk-norm) and one MLP (biases or the
    gate), on the perturbed params of layer 0."""
    ja, _, jp, tp = FC.archs(name)
    rng = np.random.default_rng(1)
    x = (0.5 * rng.standard_normal((2, 16, ja.cfg.d_model))).astype(
        np.float32)
    pos = np.arange(16)
    layer = lambda t, i: {k: v[0] for k, v in t["stack0"][i].items()}
    jo, _ = JL.apply_attention(layer(jp, "attn"), jnp.asarray(x), ja.cfg,
                               positions=jnp.asarray(pos))
    to, _ = TL.apply_attention(layer(tp, "attn"), torch.from_numpy(x),
                               ja.cfg, positions=torch.from_numpy(pos))
    FC.close(to, jo, "attention")
    jm = JL.apply_mlp(layer(jp, "mlp"), jnp.asarray(x), ja.cfg)
    tm = TL.apply_mlp(layer(tp, "mlp"), torch.from_numpy(x), ja.cfg)
    FC.close(tm, jm, "mlp")


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grads_match_jax(name):
    FC.check_loss_and_grads(name)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_jax(name):
    FC.check_prefill_decode(name)


@pytest.mark.parametrize("name", DENSE)
def test_round_matches_jax(name):
    FC.check_round(name)


@pytest.mark.parametrize("name", DENSE + ["diloco_60m", "diloco_150m",
                                          "diloco_400m"])
def test_paged_equals_contiguous(name):
    FC.check_paged_equals_contiguous(name)
