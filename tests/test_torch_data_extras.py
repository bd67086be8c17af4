"""The DiLoCo extras of the port against the JAX package: the Markov
mixture's ``regroup`` (V=64, k=8 regrouped to 4, 2 and 1 workers: group
logits, shard sizes, the unchanged validation mixture and its entropy
floor), ``batch_iterator``'s determinism and shapes, and
``sync_inner_state``, a config field that neither package reads: a round
with it on equals the round with it off, bit for bit in the port, and
both equal the JAX round.

Tolerances: regroup's logits atol 1e-5 (the softmaxes and logs of two
libraries round their last bits apart; the logits are O(10)); the
round's state atol 1e-5, rtol 1e-4, ``tests/test_torch_diloco.py``'s
round tolerance."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.data.pipeline import MarkovMixture, batch_iterator  # noqa: E402,E501
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
SIZES = np.arange(1, 9, dtype=np.float32)


@pytest.fixture(scope="module")
def mixtures():
    j = JMarkov(vocab_size=64, k=8, seed=3, shard_sizes=SIZES)
    t = MarkovMixture(vocab_size=64, k=8, seed=3, shard_sizes=SIZES,
                      device="cpu", chunk_rows=16)
    return j, t


@pytest.mark.parametrize("k_workers", [4, 2, 1])
def test_regroup_matches_jax(mixtures, k_workers):
    j, t = mixtures
    jg, tg = j.regroup(k_workers), t.regroup(k_workers)
    assert tg.k == jg.k == k_workers
    np.testing.assert_allclose(tg._logits.numpy(), np.asarray(jg._logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tg.shard_sizes, jg.shard_sizes)
    # the validation mixture is untouched (the same tensor, not a copy)
    assert tg._mix_logits is t._mix_logits
    np.testing.assert_allclose(tg._mix_logits.numpy(),
                               np.asarray(jg._mix_logits), rtol=0,
                               atol=1e-5)
    assert tg.entropy_floor() == pytest.approx(jg.entropy_floor(),
                                               rel=1e-5)
    # the original keeps its k shards
    assert t.k == 8 and t._logits.shape[0] == 8
    tok = tg.sample_all_shards(torch.Generator().manual_seed(0), 2, 8)
    assert tok.shape == (k_workers, 2, 8)


def test_regroup_refuses_more_workers_than_shards(mixtures):
    with pytest.raises(ValueError, match="k_workers"):
        mixtures[1].regroup(9)


@pytest.mark.parametrize("mode,shape", [("shards", (8, 3, 12)),
                                        ("validation", (3, 12))])
def test_batch_iterator_is_deterministic(mixtures, mode, shape):
    t = mixtures[1]
    a = batch_iterator(t, 3, 12, seed=5, mode=mode)
    b = batch_iterator(t, 3, 12, seed=5, mode=mode)
    first = [next(a) for _ in range(3)]
    for x, y in zip(first, (next(b) for _ in range(3))):
        assert x.shape == shape and x.dtype == torch.int64
        assert torch.equal(x, y)
        assert int(x.min()) >= 0 and int(x.max()) < 64
    assert not torch.equal(first[0], first[1])       # steps differ
    other = next(batch_iterator(t, 3, 12, seed=6, mode=mode))
    assert not torch.equal(other, first[0])          # seeds differ
    with pytest.raises(ValueError, match="mode"):
        next(batch_iterator(t, 3, 12, mode="nope"))


def _round(sync_inner_state: bool):
    """One k=2, H=3 round of the diloco_150m smoke config in each package
    from one JAX state, on the JAX sampler's tokens."""
    B, S, k, H = 2, 16, 2, 3
    tc = dict(inner_lr=1e-3, warmup_steps=2, total_steps=12)
    jarch = jreg.get_smoke_arch("diloco_150m")
    tarch = treg.get_smoke_arch("diloco_150m")
    params, _ = jarch.init(jax.random.PRNGKey(1))
    jd = JDCfg(k=k, H=H, sync_inner_state=sync_inner_state)
    jstate0 = JD.init_state(params, jd)
    sampler = JMarkov(vocab_size=jarch.cfg.vocab_size, k=k, seed=0)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, H)
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(keys), 0, 1)[:k])
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b),
                         sampler.sample_all_shards, jd, JTCfg(**tc),
                         batch_size=B, seq_len=S)
    jstate, _ = jrnd(jstate0, key)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate0),
                                     device="cpu")
    flat = torch.from_numpy(toks).long().reshape(k, H * B, S)
    trnd = TD.make_round(lambda p, b: tarch.loss(p, b),
                         lambda g, b, s: flat,
                         DiLoCoConfig(k=k, H=H,
                                      sync_inner_state=sync_inner_state),
                         TrainConfig(**tc), batch_size=B, seq_len=S)
    state, _ = trnd(state, None)
    s = jax.tree.map(np.asarray, jstate)
    want = {"global_params": s.global_params,
            "outer_state": {"buf": s.outer_state.buf,
                            "buf2": s.outer_state.buf2,
                            "count": s.outer_state.count},
            "replica_params": s.replica_params,
            "inner_state": {"m": s.inner_state.m, "v": s.inner_state.v,
                            "count": s.inner_state.count},
            "outer_t": s.outer_t, "inner_steps_done": s.inner_steps_done}
    return convert.state_to_numpy(state), want


def test_sync_inner_state_runs_the_same_round_as_jax():
    got_on, want_on = _round(True)
    got_off, want_off = _round(False)
    on, off = dict(tree.paths(got_on)), dict(tree.paths(got_off))
    assert sorted(on) == sorted(off)
    for path in on:                      # the field changes nothing
        np.testing.assert_array_equal(on[path], off[path], err_msg=path)
    jon, joff = dict(tree.paths(want_on)), dict(tree.paths(want_off))
    for path in jon:                     # nor does it in JAX
        np.testing.assert_array_equal(jon[path], joff[path], err_msg=path)
    assert sorted(on) == sorted(jon)
    for path in on:
        np.testing.assert_allclose(on[path], jon[path], rtol=1e-4,
                                   atol=1e-5, err_msg=path)
