"""The port's chunked round driver (``core.diloco.make_run``) against its
per-round ``make_round``, and the first milestone: ten rounds of the JAX
``make_run`` at smoke width against the port's, round by round.

The milestone starts both packages from the JAX params, hands the port
the tokens that JAX's ``split_chain`` keys draw, and compares every
round's inner loss and val loss. Bound 2e-5 on both (absolute, losses
near 5.5): over the ten rounds the largest difference measured on the
CPU (diloco_60m's smoke config, k=2, H=4, batch 2, seq 32) is 4.8e-7 in
the inner loss and 1.9e-6 in the val loss, a tenth of the bound. The
matmuls and the gradient norm reduce in another order in the two
packages, and those last-bit differences pass through AdamW's
normalisation (one round of the same state holds to atol 1e-5 leaf by
leaf, ``tests/test_torch_diloco.py``).
"""
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
from repro_torch import convert, resilience  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.data.sharding import make_regime  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
B, S = 2, 32
MILESTONE_TOL = 2e-5


def _port_setup(k=2, H=2, rounds=4):
    arch = treg.get_smoke_arch("diloco_150m")
    dcfg = DiLoCoConfig(k=k, H=H)
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=rounds * H)
    sampler = make_regime("non_iid", k=k, vocab_size=arch.cfg.vocab_size,
                          device="cpu")
    params = arch.init(generator=torch.Generator().manual_seed(0),
                       device="cpu")
    return arch, dcfg, tcfg, sampler, params


@pytest.mark.parametrize("drop", [False, True])
def test_make_run_bit_identical_to_make_round(drop):
    """One make_run(R) call and R make_round calls on the same generator:
    the same final state (by digest), the same generator state, and each
    round's metrics equal; with drop masks, replica 1 keeps its own params
    in round 2."""
    R = 3
    arch, dcfg, tcfg, sampler, params = _port_setup(rounds=R)
    loss_fn = lambda p, b: arch.loss(p, b)
    drops = np.ones((R, dcfg.k), np.float32)
    if drop:
        drops[1, 1] = 0.0
    out = {}
    for how in ("round", "run"):
        state = TD.init_state(params, dcfg)
        gen = torch.Generator().manual_seed(7)
        if how == "round":
            rnd = TD.make_round(loss_fn, sampler.sample_all_shards, dcfg,
                                tcfg, batch_size=B, seq_len=S)
            ms = []
            for t in range(R):
                state, m = rnd(state, gen, drops[t])
                ms.append({n: float(m[n]) for n in ("inner_loss",
                                                    "outer_gnorm")})
        else:
            run = TD.make_run(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                              rounds_per_call=R, batch_size=B, seq_len=S)
            state, m = run(state, gen, drops)
            assert m["inner_loss"].shape == (R,)
            ms = [{n: float(m[n][t]) for n in ("inner_loss", "outer_gnorm")}
                  for t in range(R)]
        out[how] = (resilience.tree_sha256(state), ms,
                    bytes(gen.get_state().numpy()))
    assert out["run"] == out["round"]


def test_make_run_adds_no_host_sync(monkeypatch):
    """A chunk synchronizes only where each round already does (after the
    draw, the inner phase and the outer step, for their seconds): the
    eval and the stacking add none, and the losses stay device tensors
    until ``RunRecorder.ingest_chunk`` copies them."""
    R = 3
    arch, dcfg, tcfg, sampler, params = _port_setup(rounds=R)
    syncs = []
    real = TD._sync
    monkeypatch.setattr(TD, "_sync", lambda d: (syncs.append(d), real(d)))
    val = sampler.sample_validation(torch.Generator().manual_seed(1), 2, S)
    run = TD.make_run(lambda p, b: arch.loss(p, b), sampler.sample_all_shards,
                      dcfg, tcfg, rounds_per_call=R, batch_size=B, seq_len=S,
                      eval_tokens=val)
    _, m = run(TD.init_state(params, dcfg), torch.Generator().manual_seed(0))
    assert len(syncs) == 3 * R
    for name in ("inner_loss", "outer_gnorm", "val_loss"):
        assert torch.is_tensor(m[name]) and m[name].shape == (R,)


def test_eval_cadence_with_round_offset():
    """Rounds whose global index round_offset + t + 1 divides by
    eval_every report the val loss, and the last round of the call; the
    others NaN. The evaluated value is the global params' loss."""
    arch, dcfg, tcfg, sampler, params = _port_setup(rounds=6)
    loss_fn = lambda p, b: arch.loss(p, b)
    val = sampler.sample_validation(torch.Generator().manual_seed(1), 2, S)
    run = TD.make_run(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                      rounds_per_call=4, batch_size=B, seq_len=S,
                      eval_tokens=val, eval_every=3)
    state = TD.init_state(params, dcfg)
    state, m = run(state, torch.Generator().manual_seed(0), round_offset=2)
    vl = m["val_loss"].numpy()
    assert np.isfinite(vl).tolist() == [True, False, False, True]
    assert float(vl[3]) == float(TD.make_eval(loss_fn)(state.global_params,
                                                       val))


def _jax_milestone(jarch, jparams, sampler, rounds, k, H, val):
    jd = JDCfg(k=k, H=H)
    tc = JTCfg(inner_lr=1e-3, warmup_steps=4, total_steps=rounds * H)
    run = JD.make_run(lambda p, b: jarch.loss(p, b),
                      sampler.sample_all_shards, jd, tc,
                      rounds_per_call=rounds, batch_size=B, seq_len=S,
                      eval_tokens=val, eval_every=1, donate=False)
    key = jax.random.PRNGKey(5)
    _, ms = run(JD.init_state(jparams, jd), key)
    # the tokens each round drew: its split_chain sub-key split into H
    _, subs = JD.split_chain(key, rounds)
    toks = np.stack([np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(
        jax.random.split(sub, H)), 0, 1)[:k]) for sub in subs])
    return ms, toks


def test_milestone_ten_rounds_match_jax():
    """Ten rounds (k=2, H=4) of diloco_60m's smoke config: every round's
    inner loss and val loss within MILESTONE_TOL of JAX's."""
    rounds, k, H = 10, 2, 4
    jarch = jreg.get_smoke_arch("diloco_60m")
    jparams, _ = jarch.init(jax.random.PRNGKey(2))
    sampler = JMarkov(vocab_size=jarch.cfg.vocab_size, k=k, seed=0)
    val = sampler.sample_validation(jax.random.PRNGKey(10_000), 4, S)
    jm, toks = _jax_milestone(jarch, jparams, sampler, rounds, k, H, val)

    tarch = treg.get_smoke_arch("diloco_60m")
    flat = torch.from_numpy(toks).long().reshape(rounds, k, H * B, S)
    drawn = iter(range(rounds))
    run = TD.make_run(lambda p, b: tarch.loss(p, b),
                      lambda g, b, s: flat[next(drawn)],
                      DiLoCoConfig(k=k, H=H),
                      TrainConfig(inner_lr=1e-3, warmup_steps=4,
                                  total_steps=rounds * H),
                      rounds_per_call=rounds, batch_size=B, seq_len=S,
                      eval_tokens=torch.from_numpy(np.array(val)).long(),
                      eval_every=1)
    state = TD.init_state(convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"),
        DiLoCoConfig(k=k, H=H))
    state, tm = run(state, None)
    assert state.outer_t == rounds
    for name in ("inner_loss", "val_loss"):
        got, want = tm[name].numpy(), np.asarray(jm[name])
        assert got.shape == want.shape == (rounds,)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=MILESTONE_TOL,
                                   err_msg=name)
    # the loss moves: the last val loss is below the first
    assert tm["val_loss"][-1] < tm["val_loss"][0]
