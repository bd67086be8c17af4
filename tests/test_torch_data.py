"""The port's synthetic data against the JAX package's.

The transition logits come from numpy ``default_rng(seed)`` in both
packages, in the same draw order, so they are equal; the mixture logits
and the entropy floor go through softmax/log/matmul in float32 on each
side (rtol 1e-6, atol 1e-6 on the log-probabilities). Token sampling
differs by design (``jax.random`` against a ``torch.Generator``): its
tests check shapes, ranges and determinism.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as JP  # noqa: E402
from repro.data import sharding as JS  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.data import sharding as TS  # noqa: E402

torch.set_num_threads(2)
V, K = 64, 3


@pytest.fixture(scope="module")
def pair():
    return (JP.MarkovMixture(vocab_size=V, k=K, seed=0),
            TP.MarkovMixture(vocab_size=V, k=K, seed=0, device="cpu"))


def test_logits_match_jax(pair):
    j, t = pair
    np.testing.assert_array_equal(t._logits.numpy(), np.asarray(j._logits))
    np.testing.assert_allclose(t._mix_logits.numpy(),
                               np.asarray(j._mix_logits), rtol=1e-6,
                               atol=1e-6)


def test_entropy_floor_matches_jax(pair):
    j, t = pair
    np.testing.assert_allclose(t.entropy_floor(), j.entropy_floor(),
                               rtol=1e-6)


@pytest.mark.parametrize("rows", [1, 5, 64])
def test_chunked_draw_equals_whole_draw(pair, rows):
    """Row chunks drawn in sequence from one generator continue its
    stream: any chunk size gives the whole draw's logits."""
    _, whole = pair
    t = TP.MarkovMixture(vocab_size=V, k=K, seed=0, device="cpu",
                         chunk_rows=rows)
    assert torch.equal(t._logits, whole._logits)
    assert torch.equal(t._mix_logits, whole._mix_logits)


def test_sampling_shapes_and_determinism(pair):
    _, t = pair
    draw = lambda seed, fn, *a: fn(torch.Generator().manual_seed(seed), *a)
    toks = draw(0, t.sample_all_shards, 4, 12)
    assert toks.shape == (K, 4, 12) and toks.dtype == torch.int64
    assert 0 <= int(toks.min()) and int(toks.max()) < V
    assert torch.equal(toks, draw(0, t.sample_all_shards, 4, 12))
    assert not torch.equal(toks, draw(1, t.sample_all_shards, 4, 12))
    val = draw(0, t.sample_validation, 5, 7)
    assert val.shape == (5, 7) and int(val.max()) < V


@pytest.mark.parametrize("regime", ["iid", "non_iid"])
@pytest.mark.parametrize("imbalanced", [False, True])
def test_regime_and_shard_weights_match_jax(regime, imbalanced):
    j = JS.make_regime(regime, k=K, vocab_size=16, seed=2,
                       imbalanced=imbalanced)
    t = TS.make_regime(regime, k=K, vocab_size=16, seed=2,
                       imbalanced=imbalanced, device="cpu")
    assert t.alpha == j.alpha
    np.testing.assert_array_equal(t.shard_sizes, j.shard_sizes)
    np.testing.assert_array_equal(t._logits.numpy(), np.asarray(j._logits))
    for weighted in (False, True):
        np.testing.assert_array_equal(TS.shard_weights(t, weighted),
                                      JS.shard_weights(j, weighted))
    with pytest.raises(ValueError):
        TS.make_regime("bogus", device="cpu")
