"""The cross-attention families against the JAX package at smoke width:
the VLM (``llama_3_2_vision_90b``: tanh-gated cross-attention every 2nd
layer over the ``patches`` input) and the encoder-decoder
(``whisper_large_v3``: a bidirectional encoder over the ``frames`` input
with sin-cos positions, learned decoder positions, biases, LayerNorm,
GELU). The JAX init's zero gates would hide the cross-attention, so
every zero and one leaf is perturbed (``families_common``). Checked:
``project_cross_kv``, ``_run_encoder``, loss and gradients, prefill and
decode (the cross K/V projected once at prefill and read back from the
cache), the streaming fragment partition; and that the trainer and the
continuous engine, which take no modality input, stop with an error that
names it.

Tolerances: f32, atol 1e-5, rtol 1e-4 (gradients atol 1e-6, rtol 1e-4);
fragment masks exactly."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import families_common as FC  # noqa: E402
from repro.core import fragments as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core import fragments as TF  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.batching import ContinuousBatcher  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

torch.set_num_threads(2)
VLM, ENCDEC = "llama_3_2_vision_90b", "whisper_large_v3"


@pytest.mark.parametrize("name,stack", [(VLM, "stack1"), (ENCDEC, "stack0")])
def test_project_cross_kv_matches_jax(name, stack):
    ja, _, jp, tp = FC.archs(name)
    x = FC.batch_np(ja.cfg)["patches" if name == VLM else "frames"]
    jx = {k: v[0] for k, v in jp[stack]["xattn"].items()}
    tx = {k: v[0] for k, v in tp[stack]["xattn"].items()}
    jk, jv = JL.project_cross_kv(jx, ja.cfg, jnp.asarray(x))
    tk, tv = TL.project_cross_kv(tx, ja.cfg, torch.from_numpy(x))
    FC.close(tk, jk, "cross k")
    FC.close(tv, jv, "cross v")


def test_run_encoder_matches_jax():
    ja, _, jp, tp = FC.archs(ENCDEC)
    frames = FC.batch_np(ja.cfg)["frames"]
    want = JM._run_encoder(jp, ja.cfg, jnp.asarray(frames))
    with torch.no_grad():
        got = TM._run_encoder(tp, ja.cfg, torch.from_numpy(frames))
    FC.close(got, want, "encoder")


@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_loss_and_grads_match_jax(name):
    FC.check_loss_and_grads(name)


@pytest.mark.parametrize("name", [VLM, ENCDEC])
def test_prefill_and_decode_match_jax(name):
    FC.check_prefill_decode(name)


@pytest.mark.parametrize("P", [2, 3])
def test_whisper_fragment_partition_matches_jax(P):
    """``encoder``, ``enc_ln_f`` and ``pos_table`` sit with the unstacked
    leaves, as in JAX."""
    _, _, jp, tp = FC.archs(ENCDEC)
    want = JF.partition_params(jp, P)
    got = TF.partition_params(tp, P)
    assert got.sizes == tuple(want.sizes)
    assert got.region_sizes == tuple(tuple(r) for r in want.region_sizes)
    for gm, wm in zip(got.masks, want.masks):
        FC.assert_tree_close(gm, wm, 0, 0, "mask")


@pytest.mark.parametrize("name,missing", [(VLM, "patches"),
                                          (ENCDEC, "frames")])
def test_trainer_stops_without_the_modality_input(name, missing):
    """The trainer's batches hold tokens only: the forward stops where
    JAX's does, naming the input it lacks."""
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--arch", name, "--k", "2", "--H", "2",
         "--rounds", "1", "--batch", "2", "--seq", "16"])
    with pytest.raises(ValueError, match=f"'{missing}' input"):
        train.run(args)


@pytest.mark.parametrize("name,match", [(VLM, "'patches' input"),
                                        (ENCDEC, "learned absolute")])
def test_continuous_engine_refuses(name, match):
    _, ta, _, tp = FC.archs(name)
    for paged in (True, False):
        with pytest.raises(ValueError, match=match):
            ContinuousBatcher(ta, tp, slots=2, cache_len=32, paged=paged)
