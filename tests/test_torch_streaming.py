"""The port's streaming DiLoCo (``core/fragments.py``,
``core/streaming.py``) against the JAX package's, on the simulated
transport.

Rounds run on a tiny dense config whose per-layer sizes are not multiples
of 128 (norm scales of 40, attention slabs of 1600, MLP slabs of 2880
entries per layer), so int4 scale blocks straddle the fragments' band
boundaries, where quantizing only the band would give other numbers. Both
packages start from one state (the JAX ``init_state``, handed over by
``convert``) and train on the tokens the JAX sampler drew; the JAX round
runs in ``ref`` kernel mode, the port in its default ``auto`` mode (the
kernels' plain versions on CPU tensors). Every field of the
``StreamState`` is compared after 3 rounds with drop, active and weight
masks that change from round to round, so applies that wrap into the next
round, the first-send latch and the send-time mask snapshots are live.

Tolerance: float32 leaves atol 1e-5, rtol 1e-4 (the inner steps' matmuls
and AdamW's last bits differ, as in ``tests/test_torch_diloco.py``). Under
a quantized transport an upstream last-bit difference can move a delta
across a rounding boundary of the transport and flip its int4 code (or
its bf16 rounding): that entry's transported value then differs by one
code step (the block's scale, or one bf16 ulp), and so do its residual,
its pending reduce and what they update. So at most
``check.TRANSPORT_FLIP_SHARE`` of a leaf's entries may lie outside the
tolerance: 0.1 % under int4, 0.5 % under bf16, whose step is 2^-8 of the
value where int4's is a seventh of the block's largest: a last-bit
difference of relative size e (1e-5 here) crosses a bf16 boundary with
probability about e·2^8, 0.26 %. float32 has no flips: 0. The grid reads
at most 4.7e-4 (int4) and 1.4e-3 (bf16). Each entry outside the
tolerance must also lie within ``allow`` = 1 + outer_lr·(1 + momentum)
code steps of it (``check.TransportSteps``, the steps recorded over the
port's run): a flipped code moves a value by one step, and the outer
Nesterov step carries a flip in the reduce into the globals at
outer_lr·(1 + momentum) steps. The grid reads at most 1.33 steps beyond
the tolerance (bf16 in-flight payloads), 1.00 under int4 (residuals).
Both runs' sends are recorded (the JAX package's by wrapping its
transport functions, ``transport_common.jax_sends``), and an entry
outside whose every differing code was a straddle (the two pre-rounding
values on either side of one boundary, within the float32 bound of the
operand params) is counted apart, not against the share
(``check.TransportSteps.explain``): on a 120-entry leaf a single flip
would break any share below 1/120.

The grid of rounds (P × τ × α × transport × error feedback) lies in
``tests/test_torch_stream_*.py``, one file per transport (and P), using
``run_case`` from here; each case compiles its own JAX round, and
``pytest --dist loadfile`` runs each file on one worker.
"""
from __future__ import annotations

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
from repro.core import fragments as JF  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.core import fragments as TF  # noqa: E402
from repro_torch.core import pod_collectives  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from transport_common import jax_sends  # noqa: E402

torch.set_num_threads(2)
K, H, B, S, VOCAB, ROUNDS = 3, 4, 2, 16, 64, 3
TINY = dict(name="tiny", family="dense", n_layers=4, d_model=40, n_heads=2,
            n_kv_heads=2, d_ff=72, vocab_size=VOCAB, remat=False,
            attn_chunk=32)
TCFG = dict(inner_lr=3e-3, warmup_steps=2, total_steps=ROUNDS * H)
WEIGHTS = np.array([0.5, 0.3, 0.2], np.float32)
# (drop, active) per round: all in; replica 1 dropped and replica 2
# inactive; replica 0 dropped
MASKS = [(np.ones(K, np.float32), np.ones(K, np.float32)),
         (np.array([1, 0, 1], np.float32), np.array([1, 1, 0], np.float32)),
         (np.array([0, 1, 1], np.float32), np.ones(K, np.float32))]


@functools.lru_cache(maxsize=None)
def _setup():
    """JAX and port archs of the tiny config, the JAX params (numpy), and
    each round's tokens (k, H, B, S) as the JAX round draws them."""
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


def run_case(P, tau, alpha, dtype, ef, *, jax_mode="ref", policy=None,
             prune=0.0, cosine=False, rounds=ROUNDS, inner_lr=None):
    """``rounds`` streaming rounds in both packages from the same state.
    Returns (JAX state, port state) in ``stream_state_to_numpy``'s form,
    the per-round metrics of each and the ``check.TransportSteps`` of the
    port's run."""
    jarch, tarch, params, sampler, toks = _setup()
    pol = dict(zip(("param_dtype", "master_dtype"),
                   policy or ("float32", "float32")))
    tc = dict(TCFG, **({} if inner_lr is None else {"inner_lr": inner_lr}))
    kw = dict(k=K, H=H, streaming_fragments=P, stream_tau=tau,
              stream_alpha=alpha, outer_grad_dtype=dtype, error_feedback=ef,
              prune_frac=prune, **pol)
    jd = JDCfg(kernel_mode=jax_mode, **kw)
    jt = JTCfg(kernel_mode=jax_mode, batch_size=B, seq_len=S, **pol, **tc)
    tdcfg = DiLoCoConfig(**kw)
    jstate = JS.init_state(params, jd)
    tstate = convert.stream_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tdcfg, device="cpu")
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b),
                         sampler.sample_all_shards, jd, jt, batch_size=B,
                         seq_len=S, compute_cosine=cosine)
    flat = [torch.from_numpy(t).long().reshape(K, H * B, S) for t in toks]
    trnd = TD.make_round(lambda p, b: tarch.loss(p, b),
                         lambda r, b, s: flat[r], tdcfg,
                         TrainConfig(**pol, **tc), batch_size=B,
                         seq_len=S, compute_cosine=cosine)
    jms, tms = [], []
    with check.TransportSteps(tstate.global_params, tdcfg) as steps, \
            jax_sends() as jrows:
        for r in range(rounds):
            drop, act = MASKS[r]
            jstate, jm = jrnd(jstate, jax.random.PRNGKey(10 + r),
                              jnp.asarray(drop), jnp.asarray(act),
                              jnp.asarray(WEIGHTS))
            tstate, tm = trnd(tstate, r, drop, act, WEIGHTS)
            jms.append(jm)
            tms.append(tm)
    if dtype != "float32":
        steps.explain(jrows)
    want = convert.stream_state_to_numpy(convert.stream_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tdcfg, device="cpu"))
    return want, convert.stream_state_to_numpy(tstate), jms, tms, steps


METRICS = ("inner_loss", "inner_loss_last", "outer_gnorm", "drop_frac")


def assert_case_matches(want, got, jms, tms, steps, *, transport,
                        pure=False):
    """Every StreamState leaf within the round tolerance (the transport's
    flip share, each entry outside within ``steps.allow`` code steps); the
    round metrics within atol 1e-5, rtol 1e-4; the stream byte counts
    exactly."""
    shares = check.stream_mismatch_shares(got, want, H=H, pure=pure,
                                          steps=steps)
    limit = check.TRANSPORT_FLIP_SHARE[transport]
    bad = {p: s for p, s in shares.items() if s > limit}
    explained = {p: n for p, n in steps.explained.items() if n}
    if explained:
        print("straddles explained (entries):", explained)
    assert not bad, (bad, explained, steps.unexplained[:20])
    for jm, tm in zip(jms, tms):
        for name in METRICS:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        for name in ("stream_peak_sync_bytes", "stream_round_sync_bytes"):
            assert float(tm[name]) == float(jm[name]), name


# ---------------------------------------------------------------------------
# partition and schedule
# ---------------------------------------------------------------------------

def _jax_shapes(arch):
    return jax.eval_shape(lambda: arch.init(jax.random.PRNGKey(0))[0])


def _assert_partitions_equal(tp, jp):
    assert (tp.n, tp.sizes, tp.region_sizes) == (jp.n, jp.sizes,
                                                 jp.region_sizes)
    for tm, jm in zip(tp.masks, jp.masks):
        tl, jl = tree.leaves(tm), jax.tree.leaves(jm)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).shape == np.asarray(b).shape


def _overrides(P):
    """Head and final norm pinned to the first fragment, the embedding to
    the last, in the JAX ``keystr`` form."""
    return ((r"\['head'\]", 0), (r"\['embed'\]", P - 1),
            (r"\['ln_f'\]", 0))


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("config", ["tiny", "150m_smoke", "150m_full",
                                    "tiny_override"])
def test_partition_matches_jax(config, P):
    """Masks, sizes and region sizes, for the tiny config, diloco_150m's
    smoke and full shapes (meta tensors and JAX shapes: nothing is
    allocated) and a JAX-style override in ``keystr`` form; the region
    index too."""
    overrides = _overrides(P) if config == "tiny_override" else ()
    if config.startswith("tiny"):
        _, _, params, _, _ = _setup()
        jparams = params
        tparams = convert.params_from_numpy(
            jax.tree.map(np.asarray, params), device="meta")
    else:
        get = "get_smoke_arch" if config.endswith("smoke") else "get_arch"
        jparams = _jax_shapes(getattr(jreg, get)("diloco_150m"))
        tparams = getattr(treg, get)("diloco_150m").init(generator=None,
                                                         device="meta")
    tp = TF.partition_params(tparams, P, overrides=overrides)
    jp = JF.partition_params(jparams, P, overrides=overrides)
    _assert_partitions_equal(tp, jp)
    assert [tuple(map(tuple, r)) for r in TF.fragment_regions(tp, tparams)] \
        == [tuple(map(tuple, r)) for r in JF.fragment_regions(jp, jparams)]
    assert sum(tp.sizes) == sum(t.numel() for t in tree.leaves(tparams))
    if overrides and P > 1:
        head = TF.keystr(("head", "w"))
        assert head == "['head']['w']"
        assert tp.masks[0]["head"]["w"] == 1          # pinned
        assert tp.masks[P - 1]["embed"]["table"] == 1


def test_partition_rejects_bad_override():
    _, _, params, _, _ = _setup()
    with pytest.raises(ValueError, match="out of range"):
        TF.partition_params(params, 2, overrides=((r"head", 5),))
    with pytest.raises(ValueError):
        TF.partition_params(params, 0)


def test_schedule_matches_jax():
    """Every P ∈ {1, 2, 4}, H ∈ {4, 5, 7}, τ ∈ [0, H): offsets and the
    event phases equal; bad arguments raise as in JAX."""
    for P in (1, 2, 4):
        for Hh in (4, 5, 7):
            for tau in range(Hh):
                got = TF.schedule(P, Hh, tau)
                assert got == JF.schedule(P, Hh, tau), (P, Hh, tau)
                assert sum(s for s, _ in got.phases) == Hh
    for args in ((5, 4, 0), (2, 4, 4), (2, 4, -1), (0, 4, 0)):
        with pytest.raises(ValueError):
            TF.schedule(*args)


def test_region_take_and_put_round_trip():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    reg = TF.Region(0, 1, 3, 6)
    flat = TF.region_take(x, reg, lead_axes=1)
    assert flat.shape == (2, 6)
    y = torch.zeros_like(x)
    TF.region_put(y, reg, flat, lead_axes=1)
    assert torch.equal(y[:, 1:3], x[:, 1:3]) and not y[:, 0].any()
    whole = TF.Region(0, None, None, 30)
    assert torch.equal(TF.region_take(x, whole), x.reshape(-1))


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def test_init_state_matches_jax():
    """``init_state``: zero pending, unarmed latch, zero residual and the
    in-flight slots (band-shaped payloads) equal the JAX state's, read
    through ``convert``."""
    _, _, params, _, _ = _setup()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    for kw in (dict(streaming_fragments=4, stream_tau=2,
                    outer_grad_dtype="int4", error_feedback=True),
               dict(streaming_fragments=2, outer_grad_dtype="bfloat16"),
               dict(streaming_fragments=1)):
        dcfg = DiLoCoConfig(k=K, H=H, **kw)
        want = convert.stream_state_to_numpy(convert.stream_state_from_numpy(
            jax.tree.map(np.asarray, JS.init_state(params, JDCfg(k=K, H=H,
                                                                 **kw))),
            dcfg, device="cpu"))
        got = convert.stream_state_to_numpy(TS.init_state(tparams, dcfg))
        wp, gp = dict(tree.paths(want)), dict(tree.paths(got))
        assert sorted(wp) == sorted(gp)
        for path, a in gp.items():
            np.testing.assert_array_equal(a, wp[path], err_msg=path)
        assert ("inflight" in got) == TS.deferred_consume(dcfg)


def test_p1_bit_identical_to_classic_round():
    """P=1, α=1, τ=0, float32 transport: three rounds with drop, active and
    weight masks are bit for bit the port's classic round (states and
    metrics): one full-tree send and apply at the end of the round."""
    _, tarch, params, _, toks = _setup()
    flat = [torch.from_numpy(t).long().reshape(K, H * B, S) for t in toks]
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    out = {}
    for P in (0, 1):
        dcfg = DiLoCoConfig(k=K, H=H, streaming_fragments=P)
        state = (TS.init_state if P else TD.init_state)(tparams, dcfg)
        rnd = TD.make_round(lambda p, b: tarch.loss(p, b),
                            lambda r, b, s: flat[r], dcfg,
                            TrainConfig(**TCFG), batch_size=B, seq_len=S)
        ms = []
        for r in range(ROUNDS):
            state, m = rnd(state, r, *MASKS[r], WEIGHTS)
            ms.append({n: float(m[n]) for n in METRICS})
        out[P] = (convert.state_to_numpy(state.base if P else state), ms)
    (want, wm), (got, gm) = out[0], out[1]
    assert gm == wm
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("policy,dtype,tau", [
    (("bfloat16", "float32"), "int4", 1),
    (("bfloat16", "bfloat16"), "bfloat16", 0)])
def test_low_precision_policy_with_pruning_matches_jax(policy, dtype, tau):
    """The mixed policy (deltas master against master; the working copy
    adopts the merge at bf16) and the pure bf16 one, with sign pruning at
    0.5, error feedback and α=0.5: the bf16 leaves within H bf16 ulps
    (``check.mismatch_shares``), the rest as the grid; thresholds and codes
    may flip at the flip share. Inner lr 1e-3, as in
    ``tests/test_torch_mixed.py``: a bf16 moment or gradient that rounds
    the other way moves an f32 master by a share of the step, so the
    masters' drift between the packages grows with lr."""
    want, got, jms, tms, steps = run_case(2, tau, 0.5, dtype, True,
                                          policy=policy, prune=0.5,
                                          inner_lr=1e-3)
    assert_case_matches(want, got, jms, tms, steps, transport=dtype,
                        pure=policy[1] == "bfloat16")


def test_cosine_and_sync_plan_match_jax():
    """``compute_cosine`` reads the transported deltas of the round's
    sends; ``sync_plan`` (the wire plan the trainer records) equals the
    JAX plan on the simulated transport."""
    want, got, jms, tms, steps = run_case(2, 1, 1.0, "int4", True,
                                          cosine=True, rounds=2)
    assert_case_matches(want, got, jms, tms, steps, transport="int4")
    for jm, tm in zip(jms, tms):
        for name in ("cos_mean", "cos_std"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-3, atol=1e-5, err_msg=name)
    _, _, params, _, _ = _setup()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="meta")
    for P, tau, dtype in ((1, 0, "float32"), (2, 1, "int4"),
                          (4, 3, "bfloat16"), (3, 2, "int4")):
        kw = dict(k=K, H=H, streaming_fragments=P, stream_tau=tau,
                  outer_grad_dtype=dtype)
        assert TS.sync_plan(tparams, DiLoCoConfig(**kw)) == \
            JS.sync_plan(params, JDCfg(**kw))


def test_int4_round_matches_jax_interpret():
    """One int4 case against the JAX round in ``interpret`` mode (its
    Pallas kernels: fake_quant, AdamW, Nesterov)."""
    want, got, jms, tms, steps = run_case(4, 2, 0.5, "int4", True,
                                          jax_mode="interpret", rounds=2)
    assert_case_matches(want, got, jms, tms, steps, transport="int4")


def test_flip_check_bounds_how_far_an_entry_is_off():
    """An entry outside the tolerance passes ``stream_mismatch_shares``
    only within ``allow`` code steps: one sign flipped in a pending, an
    in-flight or a global leaf, or eight in-flight entries at twice their
    block's scale, stay far below the flip share but fail with the steps
    recorded over the run (and pass without them)."""
    want, got, jms, tms, steps = run_case(4, 2, 0.5, "int4", True,
                                          rounds=2)
    limit = check.TRANSPORT_FLIP_SHARE["int4"]
    assert steps.allow == pytest.approx(1 + 0.7 * 1.9)
    assert max(check.stream_mismatch_shares(got, want, H=H,
                                            steps=steps).values()) <= limit

    def corrupt(path, n, factor):
        bad = {"base": dict(got["base"])}
        bad.update({key: v for key, v in got.items() if key != "base"})
        node, keys = bad, path.split(".")
        for key in keys[:-1]:
            node[key] = dict(node[key])
            node = node[key]
        leaf = node[keys[-1]].copy()
        flat = leaf.reshape(-1)
        i = int(np.abs(flat).argmax())
        flat[i:i + n] *= factor
        node[keys[-1]] = leaf
        return bad

    for path, n, factor in (("pending.stack0.mlp.w_down", 1, -1.0),
                            ("inflight.1.payload.9", 1, -1.0),
                            ("base.global_params.stack0.mlp.w_up", 1, -1.0),
                            ("inflight.1.payload.9", 8, 2.0)):
        bad = corrupt(path, n, factor)
        loose = check.stream_mismatch_shares(bad, want, H=H)
        assert 0 < loose[path] <= limit, path
        assert check.stream_mismatch_shares(
            bad, want, H=H, steps=steps)[path] == 1.0, path


def test_streaming_round_refusals():
    loss = lambda p, b: (0.0, {})
    with pytest.raises(NotImplementedError, match="nesterov"):
        TD.make_round(loss, None, DiLoCoConfig(streaming_fragments=2,
                                               outer_opt="adam"),
                      TrainConfig())
    # the sharded transport needs this rank's pod group, pods dividing
    # k, and no cosine statistics (the JAX round's refusals)
    sharded = DiLoCoConfig(streaming_fragments=2, transport="sharded", k=4)
    with pytest.raises(ValueError, match="pod group"):
        TD.make_round(loss, None, sharded, TrainConfig())
    pods3 = pod_collectives.PodGroup(0, 3, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="cannot be banded over 3 pods"):
        TD.make_round(loss, None, sharded, TrainConfig(), group=pods3)
    pods2 = pod_collectives.PodGroup(0, 2, device="cpu", backend="gloo")
    with pytest.raises(NotImplementedError, match="cross-pod"):
        TD.make_round(loss, None, sharded, TrainConfig(), group=pods2,
                      compute_cosine=True)
    with pytest.raises(ValueError, match="P <= H"):
        TD.make_round(loss, None, DiLoCoConfig(streaming_fragments=5, H=4),
                      TrainConfig())
