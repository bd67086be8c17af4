"""The port's gossip transport (``core/gossip.py``) against the JAX
package's: pairings, the exchange and three rounds of the gossip round.

- ``partner_map`` and ``pairing_edges`` equal JAX's: butterfly for k ∈ {2,
  4, 8} and several t; random (odd k too) given the permutation JAX drew
  from its round key (the port draws its own from a ``torch.Generator``
  seeded from (seed, PAIR_FOLD, t): same structure, other numbers).
- ``mix_round`` equals JAX's bit for bit at float32 (the same expression
  in the same order) and at a bf16 exchange (the round trip rounds to
  nearest even in both), with dropped and self-paired workers gated.
- The butterfly property of JAX's ``tests/test_gossip.py``: log2 k rounds
  at mix 0.5 take any disagreement to the mean.
- Three gossip rounds of a tiny transformer (k=4, P=2, random pairing on
  JAX's partner maps, a dropped link, a preempted worker) from one state
  and on the tokens the JAX sampler drew, JAX's ``make_round(transport=
  "gossip")`` in ``ref`` mode against the port's round in ``auto`` mode
  (plain versions on CPU tensors): every ``GossipState`` field within
  atol 1e-5, rtol 1e-4 (``check.gossip_mismatch_shares``). At float32
  nothing lies outside. Under the bf16 exchange an upstream last-bit
  difference can round a partner's estimate to the other bf16 neighbour:
  at most ``check.TRANSPORT_FLIP_SHARE["bfloat16"]`` of a leaf's entries
  may lie outside, each within 1 + outer_lr·(1 + momentum) bf16 steps of
  the estimate beyond it (this grid reads at most 3.9e-5 of a leaf).
- ``validate`` refuses what JAX refuses, with its messages; a pod group
  is refused.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import ModelConfig as JMCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.core import gossip as JG  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.core import gossip as TG  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import outer_nesterov as TON  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
K, H, B, S, VOCAB, ROUNDS = 4, 3, 2, 16, 64, 3
TINY = dict(name="tiny", family="dense", n_layers=4, d_model=40, n_heads=2,
            n_kv_heads=2, d_ff=72, vocab_size=VOCAB, remat=False,
            attn_chunk=32)
TCFG = dict(inner_lr=3e-3, warmup_steps=2, total_steps=ROUNDS * H)
# (drop, active) per round: all in; worker 1's link down and worker 2
# preempted; worker 0's link down
MASKS = [(np.ones(K, np.float32), np.ones(K, np.float32)),
         (np.array([1, 0, 1, 1], np.float32),
          np.array([1, 1, 0, 1], np.float32)),
         (np.array([0, 1, 1, 1], np.float32), np.ones(K, np.float32))]


def _jax_perm(k, key):
    return np.asarray(jax.random.permutation(key, k))


# ---------------------------------------------------------------------------
# pairings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4, 8])
def test_butterfly_partners_and_edges_match_jax(k):
    for t in range(6):
        want = np.asarray(JG.partner_map(k, t, "butterfly"))
        got = TG.partner_map(k, t, "butterfly")
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
        assert TG.pairing_edges(k, t, "butterfly") == \
            JG.pairing_edges(k, t, "butterfly")


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_random_partners_and_edges_match_jax_given_its_permutation(k):
    """Given the permutation JAX drew, the same matching and edges (the
    odd worker sits out); the port's own draws are involutions too and
    depend only on (seed, t)."""
    for t in range(4):
        rk = jax.random.PRNGKey(100 * k + t)
        pk = jax.random.fold_in(rk, JG.PAIR_FOLD)
        want = np.asarray(JG.partner_map(k, t, "random", key=pk))
        perm = _jax_perm(k, pk)
        np.testing.assert_array_equal(
            TG.partner_map(k, t, "random", perm=perm), want)
        assert TG.pairing_edges(k, t, "random", perm=perm) == \
            JG.pairing_edges(k, t, "random", round_key=rk)
        own = TG.partner_map(k, t, "random", seed=7)
        np.testing.assert_array_equal(own[own], np.arange(k))
        assert int((own == np.arange(k)).sum()) == k % 2
        np.testing.assert_array_equal(
            own, TG.partner_map(k, t, "random", seed=7))
    assert TG.PAIR_FOLD == JG.PAIR_FOLD
    draws = {tuple(TG.random_perm(8, 0, t)) for t in range(6)}
    assert len(draws) > 1                  # a fresh matching per round


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _est(k, seed=0):
    rng = np.random.default_rng(seed)
    return {"stack": rng.normal(size=(k, 3, 4, 5)).astype(np.float32),
            "w": rng.normal(size=(k, 6, 7)).astype(np.float32),
            "b": rng.normal(size=(k, 9)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mix", [0.5, 0.3])
def test_mix_round_matches_jax(dtype, mix):
    """Bit for bit with JAX's ``mix_round``: a layer-band mask on the
    stacked leaf, a leaf out of the fragment, a dropped worker (ok 0) and
    random partners."""
    k = 4
    est = _est(k)
    masks = {"stack": np.array([1, 0, 1], np.float32).reshape(3, 1, 1),
             "w": np.float32(1.0), "b": np.float32(0.0)}
    ok = np.array([1, 1, 0, 1], np.float32)
    for partner in (TG.partner_map(k, 1, "butterfly"),
                    TG.partner_map(k, 0, "random", seed=3)):
        want = JG.mix_round(jax.tree.map(jnp.asarray, est),
                            jnp.asarray(partner), masks, mix=mix,
                            ok=jnp.asarray(ok), quant_dtype=dtype)
        got = TG.mix_round(tree.map(torch.from_numpy, est), partner, masks,
                           mix=mix, ok=ok, quant_dtype=dtype)
        for name in est:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]), name)


def test_butterfly_mixes_to_the_mean_in_log2k_rounds():
    """JAX's proven schedule, in the port: with mix=0.5 and full masks,
    log2(k) butterfly stages take any disagreement to the mean."""
    k = 8
    rng = np.random.default_rng(0)
    est = {"a": torch.from_numpy(rng.normal(size=(k, 4, 3)).astype(
        np.float32)), "b": torch.from_numpy(rng.normal(size=(k, 5)).astype(
            np.float32))}
    mask = {"a": 1.0, "b": 1.0}
    want = tree.map(lambda g: g.numpy().mean(0), est)
    for t in range(3):
        est = TG.mix_round(est, TG.partner_map(k, t, "butterfly"), mask,
                           mix=0.5)
    for name, m in want.items():
        got = est[name].numpy()
        np.testing.assert_allclose(got, np.broadcast_to(m, got.shape),
                                   rtol=2e-6, atol=2e-6)
        assert float((got.max(0) - got.min(0)).max()) < 4e-7


def test_butterfly_swap_and_gating():
    """The structured swap equals indexing by the partner map; a gated
    exchange (ok 0, or a self-paired worker) moves nothing; a bf16
    exchange still contracts the disagreement."""
    for k, stage in [(2, 0), (4, 0), (4, 1), (8, 2)]:
        g = torch.from_numpy(np.random.default_rng(1).normal(
            size=(k, 3, 5)).astype(np.float32))
        p = torch.from_numpy(TG.partner_map(k, stage, "butterfly")).long()
        torch.testing.assert_close(g[p], TG.butterfly_swap(stage, k)(g),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError):
        TG.butterfly_swap(2, 4)
    est = {"a": torch.from_numpy(_est(4)["w"])}
    out = TG.mix_round(est, TG.partner_map(4, 0, "butterfly"), {"a": 1.0},
                       mix=0.5, ok=np.zeros(4, np.float32))
    assert torch.equal(out["a"], est["a"])
    one = {"a": est["a"][:1]}
    assert torch.equal(TG.mix_round(one, TG.partner_map(1, 0, "butterfly"),
                                    {"a": 1.0}, mix=0.5)["a"], one["a"])
    two = {"a": torch.tensor([[1.0, 2.0], [3.0, 8.0]])}
    out = TG.mix_round(two, TG.partner_map(2, 0, "butterfly"), {"a": 1.0},
                       mix=0.5, quant_dtype="bfloat16")
    assert float((out["a"][0] - out["a"][1]).abs().sum()) < 0.1 * 8.0


# ---------------------------------------------------------------------------
# three rounds against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _setup():
    jarch = jreg.Arch(cfg=JMCfg(**TINY))
    tarch = treg.Arch(cfg=ModelConfig(**TINY))
    params, _ = jarch.init(jax.random.PRNGKey(0), jarch.cfg)
    sampler = JMarkov(vocab_size=VOCAB, k=K, seed=0)
    toks = []
    for r in range(ROUNDS):
        keys = jax.random.split(jax.random.PRNGKey(10 + r), H)
        toks.append(np.array(jnp.swapaxes(jax.vmap(
            lambda kk: sampler.sample_all_shards(kk, B, S))(keys),
            0, 1)[:K]))
    return jarch, tarch, params, sampler, toks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_gossip_rounds_match_jax(dtype):
    """Every ``GossipState`` field after three rounds, the round metrics,
    and the partner maps the port's hook was handed (JAX's)."""
    jarch, tarch, params, sampler, toks = _setup()
    kw = dict(k=K, H=H, transport="gossip", gossip_pairing="random",
              gossip_mix=0.5, streaming_fragments=2, outer_grad_dtype=dtype)
    jd = JDCfg(kernel_mode="ref", **kw)
    jt = JTCfg(kernel_mode="ref", batch_size=B, seq_len=S, **TCFG)
    jstate = JG.init_state(params, jd)
    tstate = convert.gossip_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu")
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b),
                         sampler.sample_all_shards, jd, jt, batch_size=B,
                         seq_len=S)
    partners = [np.asarray(JG.partner_map(K, r, "random", key=(
        jax.random.fold_in(jax.random.PRNGKey(10 + r), JG.PAIR_FOLD))))
        for r in range(ROUNDS)]
    asked = []

    def partner_fn(t):
        asked.append(t)
        return partners[t]

    flat = [torch.from_numpy(t).long().reshape(K, H * B, S) for t in toks]
    trnd = TG.make_gossip_round_body(
        lambda p, b: tarch.loss(p, b), lambda r, b, s: flat[r],
        DiLoCoConfig(**kw), TrainConfig(batch_size=B, seq_len=S, **TCFG),
        batch_size=B, seq_len=S, partner_fn=partner_fn)
    for r in range(ROUNDS):
        drop, act = MASKS[r]
        jstate, jm = jrnd(jstate, jax.random.PRNGKey(10 + r),
                          jnp.asarray(drop), jnp.asarray(act),
                          jnp.ones((K,), jnp.float32))
        tstate, tm = trnd(tstate, r, drop, act, None)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert asked == [0, 1, 2]
    want = convert.gossip_state_to_numpy(convert.gossip_state_from_numpy(
        jax.tree.map(np.asarray, jstate), device="cpu"))
    got = convert.gossip_state_to_numpy(tstate)
    shares = check.gossip_mismatch_shares(got, want, H=H,
                                          dcfg=DiLoCoConfig(**kw))
    limit = check.TRANSPORT_FLIP_SHARE[dtype]
    assert not {p: s for p, s in shares.items() if s > limit}
    assert int(tstate.outer_t) == ROUNDS
    np.testing.assert_array_equal(tstate.outer_state.count, [3, 3, 2, 3])


def test_round_launches_one_kernel_per_leaf():
    """Under a kernel mode the local update is one ``outer_nesterov`` call
    per leaf of the stacked (k, ...) estimates and the bf16 exchange one
    ``fake_quant`` per leaf (here their plain versions, on CPU tensors,
    through the same wrappers: counted where the kernel would launch on a
    card, so here 0); ``make_round`` builds the gossip round and
    ``make_run`` evaluates its consensus."""
    tarch = treg.get_smoke_arch("diloco_60m")
    dcfg = DiLoCoConfig(k=2, H=2, transport="gossip", streaming_fragments=2,
                        outer_grad_dtype="bfloat16")
    tcfg = TrainConfig(batch_size=2, seq_len=16, inner_lr=1e-3,
                       warmup_steps=1, total_steps=4)
    gen = torch.Generator().manual_seed(0)
    params = tarch.init(generator=gen, device="cpu")
    toks = torch.randint(0, tarch.cfg.vocab_size, (2, 4, 16), generator=gen)
    calls = {"nesterov": 0, "quant": 0}
    nest, quant = kops.nesterov_update_tree, kops.quant_roundtrip

    def count_nest(p, d, b, **kw):
        calls["nesterov"] += len(tree.leaves(p))
        assert tree.leaves(p)[0].shape[0] == 2     # the stacked leaves
        return nest(p, d, b, **kw)

    def count_quant(x, dtype, **kw):
        calls["quant"] += 1
        assert kw.get("stacked") and x.shape[0] == 2
        return quant(x, dtype, **kw)

    before = (TON.launches, dict(TQ.launches))
    kops.nesterov_update_tree, kops.quant_roundtrip = count_nest, count_quant
    try:
        run = TD.make_run(lambda p, b: tarch.loss(p, b),
                          lambda g, b, s: toks, dcfg, tcfg,
                          rounds_per_call=2, batch_size=2, seq_len=16,
                          eval_tokens=toks[0, :2])
        state, m = run(TG.init_state(params, dcfg), None)
    finally:
        kops.nesterov_update_tree, kops.quant_roundtrip = nest, quant
    n = len(tree.leaves(params))
    assert calls == {"nesterov": 2 * n, "quant": 2 * n}
    assert (TON.launches, dict(TQ.launches)) == before
    assert isinstance(state, TG.GossipState) and state.outer_t == 2
    assert m["val_loss"].shape == (2,) and torch.isfinite(
        m["val_loss"]).all()
    assert m["gossip_frag"].tolist() == [0.0, 1.0]


def test_validate_matches_jax():
    """The same refusals with JAX's messages; random pairing lifts the
    power-of-2 rule; a pod group is refused."""
    base = dict(k=4, H=2, transport="gossip")
    for bad in (dict(k=3), dict(gossip_pairing="ring"),
                dict(gossip_mix=1.5), dict(outer_grad_dtype="int4"),
                dict(error_feedback=True), dict(prune_frac=0.5)):
        with pytest.raises(ValueError) as want:
            JG.validate(JDCfg(**dict(base, **bad)))
        with pytest.raises(ValueError) as got:
            TG.validate(DiLoCoConfig(**dict(base, **bad)))
        assert str(got.value) == str(want.value)
    TG.validate(DiLoCoConfig(**dict(base, k=3, gossip_pairing="random")))
    with pytest.raises(ValueError, match="drop group="):
        TG.make_gossip_round_body(None, None, DiLoCoConfig(**base),
                                  TrainConfig(), group=object())
    dcfg = DiLoCoConfig(**base, streaming_fragments=2,
                        outer_grad_dtype="bfloat16")
    params = treg.get_smoke_arch("diloco_60m").init(generator=None,
                                                    device="meta")
    jparams = tree.map(lambda x: np.zeros(tuple(x.shape), np.float32),
                       params)
    assert TG.frag_bytes(params, dcfg) == JG.frag_bytes(
        jparams, dataclasses.replace(JDCfg(**base), streaming_fragments=2,
                                     outer_grad_dtype="bfloat16"))
