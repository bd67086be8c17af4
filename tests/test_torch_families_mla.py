"""The MLA + MoE family (``deepseek_v2_lite_16b``: latent K/V of rank
512 → smoke 64, decoupled RoPE, 2 → 1 shared experts) against the JAX
package at smoke width: ``apply_mla`` in training (latents up-projected
to per-head K/V) and in the absorbed decode (scores in latent space,
the ring written past its wrap), loss and gradients, prefill and decode,
one k=2, H=2 DiLoCo round, the MoE drop case, and the port's paged
engine against its contiguous one.

Tolerances: f32, atol 1e-5, rtol 1e-4 (gradients atol 1e-6, rtol 1e-4);
positions exactly."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import families_common as FC  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402

torch.set_num_threads(2)
NAME = "deepseek_v2_lite_16b"


def _layer0(t):
    return {k: v[0] for k, v in t["stack0"]["mla"].items()}


def test_apply_mla_train_matches_jax():
    ja, _, jp, tp = FC.archs(NAME)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, ja.cfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    jo, _ = JMLA.apply_mla(_layer0(jp), jnp.asarray(x), ja.cfg,
                           positions=jnp.asarray(pos))
    to, _ = TMLA.apply_mla(_layer0(tp), torch.from_numpy(x), ja.cfg,
                           positions=torch.from_numpy(pos))
    FC.close(to, jo, "mla train")


@pytest.mark.parametrize("S,pos0", [(12, 0), (1, 12), (1, 15), (3, 14)])
def test_apply_mla_absorbed_decode_matches_jax(S, pos0):
    """A ring of 16 prefilled to 12 tokens from seeded values: prefill
    into it, one-token decodes, and a 3-token write that wraps."""
    ja, _, jp, tp = FC.archs(NAME)
    cfg = ja.cfg
    rng = np.random.default_rng(S + pos0)
    cache = {k: np.array(v) for k, v in
             JMLA.init_mla_cache(cfg, 2, 16, jnp.float32).items()}
    if pos0:
        cache["ckv"][:, :12] = rng.standard_normal((2, 12, cfg.kv_lora_rank))
        cache["kr"][:, :12] = rng.standard_normal((2, 12, cfg.rope_head_dim))
        cache["pos"][:, :12] = np.arange(12)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = pos0 + np.arange(S)
    jo, jc = JMLA.apply_mla(_layer0(jp), jnp.asarray(x), cfg,
                            positions=jnp.asarray(pos),
                            cache=jax.tree.map(jnp.asarray, cache),
                            cache_pos=jnp.asarray(pos0, jnp.int32))
    with torch.no_grad():
        to, tc = TMLA.apply_mla(
            _layer0(tp), torch.from_numpy(x), cfg,
            positions=torch.from_numpy(pos),
            cache={k: torch.from_numpy(v.copy()) for k, v in cache.items()},
            cache_pos=pos0)
    FC.close(to, jo, "mla decode")
    FC.assert_tree_close(tc, jc, what="mla cache")


def test_loss_and_grads_match_jax():
    FC.check_loss_and_grads(NAME)


def test_loss_and_grads_with_drops_match_jax():
    FC.check_loss_and_grads(NAME, capacity_factor=0.5)


def test_prefill_and_decode_match_jax():
    FC.check_prefill_decode(NAME)


def test_round_matches_jax():
    FC.check_round(NAME)


def test_paged_equals_contiguous():
    FC.check_paged_equals_contiguous(NAME)
