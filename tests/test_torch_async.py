"""The port's barrier-free async DiLoCo (``core/async_diloco.py``) against
the JAX package's ``AsyncEngine``, and its trainer path.

Both engines run the same ``faults.Scenario`` on a tiny dense config
whose leaves are not multiples of 128 entries (norm scales of 40,
attention slabs of 1600, MLP slabs of 2880), so the int4 blocks of the
ONE flat payload straddle two leaves, as JAX's ``ravel_pytree`` makes
them; a per-leaf quantization would give other numbers. Both start from
the JAX ``init_state`` (handed over by ``convert``); the port trains on
the tokens the JAX engine draws, in timeline order (JAX keys each phase
by its uid; the port cannot reproduce ``jax.random``). JAX runs in
``ref`` kernel mode, the port in ``auto`` (the kernels' plain versions on
CPU tensors). After the run every field of ``state_to_tree`` (global,
outer buffers and count, each worker's params, moments, master, residual,
version and flag, the live snapshots, the counters) and every event
record are compared.

Scenario A: speeds (1, 2) over 4 ticks: worker 0 arrives at ticks 1-4,
worker 1 at 2 and 4, stale by 2 (its snapshot is two versions old: an
alias of the global would show here). Scenario B
(``test_torch_async_faults.py``): speeds (1, 2), drop 0.3 with one
retry, worker 1 preempted from tick 3 to 5, seed 0, 8 ticks: a Lost
phase, a Leave, a Join (fresh moments and residual), a retried arrival.

Tolerance: float32 leaves atol 1e-5, rtol 1e-4 (the inner steps' matmuls
and reductions round differently, as in ``tests/test_torch_diloco.py``);
bf16 leaves of the mixed policy within H bf16 ulps of the leaf's largest
magnitude, and its float32 leaves with an extra drift of
``check.MIXED_DRIFT_PER_STEP`` · lr per inner step of the run (its bf16
gradients and moments round one ulp apart now and then, which moves the
master's AdamW step; ``check.py`` says why); counters exactly. The
float32 atol is taken once per outer application of the run
(``check.ASYNC_ATOL_PER_APPLY``: six arrivals carry six outer steps'
last-bit differences where a round carries one). Under a quantized
transport a last-bit difference in the payload can flip an int4 code (or
a bf16 rounding), so at most ``check.TRANSPORT_FLIP_SHARE`` of a leaf's
entries may lie outside the tolerance (``check.MIXED_FLIP_SHARE`` under
the mixed policy, whose payload carries the master's drift), each within
``check.TransportSteps.allow`` code steps of it (the steps recorded over
the port's run): the reasons are those of the streaming rounds
(``check.py``). Event records:
ticks, workers, uids, attempts, staleness, versions, weights and wire
bytes exactly; losses and norms atol 1e-5, rtol 1e-4 (the payload norm
under the mixed policy with the drift's share, drift·sqrt(n)).
"""
from __future__ import annotations

import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import ModelConfig as JMCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import async_diloco as JA  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.core import faults as JF  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import async_diloco as TA  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.resilience import harness  # noqa: E402
from transport_common import jax_sends  # noqa: E402

torch.set_num_threads(2)
K, H, B, S, VOCAB, EB, LAM = 2, 3, 2, 16, 64, 2, 0.7
TINY = dict(name="tiny", family="dense", n_layers=2, d_model=40, n_heads=2,
            n_kv_heads=2, d_ff=72, vocab_size=VOCAB, remat=False,
            attn_chunk=32)
TCFG = dict(inner_lr=3e-3, warmup_steps=2, total_steps=64)
SCENARIOS = {
    "A": (dict(speeds=(1, 2)), 4),
    "B": (dict(speeds=(1, 2), drop_prob=0.3, max_retries=1,
               preemptions=((1, 3, 5),), seed=0), 8),
}
# (outer_grad_dtype, error_feedback, (param_dtype, master_dtype))
CASES = [("float32", False, None), ("bfloat16", False, None),
         ("int4", False, None), ("int4", True, None),
         ("int4", True, ("bfloat16", "float32"))]
EXACT = ("event", "tick", "worker", "uid", "attempt", "staleness",
         "weight", "version", "version_at_dispatch", "wire_bytes")


@functools.lru_cache(maxsize=None)
def _setup():
    jarch = jreg.Arch(cfg=JMCfg(**TINY))
    tarch = treg.Arch(cfg=ModelConfig(**TINY))
    params, _ = jarch.init(jax.random.PRNGKey(0), jarch.cfg)
    sampler = JMarkov(vocab_size=VOCAB, k=K, seed=0)
    val = np.asarray(sampler.sample_validation(jax.random.PRNGKey(10_000),
                                               EB, S))
    return jarch, tarch, params, sampler, val


def _jax_tokens(sampler, scen, ticks, seed=0):
    """The tokens JAX's engine draws, in timeline order: per phase
    (Arrival or Lost) key = fold_in(base, uid), one batch per inner step
    from fold_in(key, h) on the worker's shard."""
    base = jax.random.PRNGKey(seed)
    out = []
    for ev in scen.timeline(K, ticks):
        if isinstance(ev, (JF.Arrival, JF.Lost)):
            key = jax.random.fold_in(base, ev.uid)
            out += [np.asarray(sampler.sample_shard(
                jax.random.fold_in(key, h), ev.worker, B, S))
                for h in range(H)]
    return out


def run_case(scenario, dtype, ef, policy=None):
    """Scenario ``scenario`` in both engines from the same state. Returns
    (JAX state, port state) in ``convert.async_state_to_numpy``'s form,
    both histories and the ``check.TransportSteps`` of the port's run."""
    jarch, tarch, params, sampler, val = _setup()
    fields, ticks = SCENARIOS[scenario]
    pol = dict(zip(("param_dtype", "master_dtype"),
                   policy or ("float32", "float32")))
    kw = dict(k=K, H=H, transport="async", staleness_lambda=LAM,
              outer_grad_dtype=dtype, error_feedback=ef, **pol)
    jd, tdcfg = JDCfg(kernel_mode="ref", **kw), DiLoCoConfig(**kw)
    jt = JTCfg(kernel_mode="ref", batch_size=B, seq_len=S, **pol, **TCFG)
    tt = TrainConfig(batch_size=B, seq_len=S, **pol, **TCFG)
    jscen, tscen = JF.Scenario(**fields), TF.Scenario(**fields)
    jsamplers = tuple((lambda i: lambda kk, b, s: sampler.sample_shard(
        kk, i, b, s))(i) for i in range(K))
    jeng = JA.AsyncEngine(lambda p, b: jarch.loss(p, b), jsamplers, jd, jt,
                          scenario=jscen, eval_fn=JD.make_eval(
                              lambda p, b: jarch.loss(p, b)),
                          eval_tokens=jax.numpy.asarray(val), donate=False)
    jstate = jeng.init_state(params)
    tstate = convert.async_state_from_numpy(
        jax.tree.map(np.asarray, JA.state_to_tree(jstate)), device="cpu")
    toks = iter(_jax_tokens(sampler, jscen, ticks))
    tsample = lambda g, b, s: torch.from_numpy(next(toks)).long()
    teng = TA.AsyncEngine(lambda p, b: tarch.loss(p, b), tsample, tdcfg, tt,
                          scenario=tscen, eval_fn=TD.make_eval(
                              lambda p, b: tarch.loss(p, b)),
                          eval_tokens=torch.from_numpy(val).long())
    with jax_sends() as jrows:
        jstate, jhist = jeng.run(jstate, ticks=ticks)
    with check.TransportSteps(tstate.global_params, tdcfg) as steps:
        tstate, thist = teng.run(tstate, ticks=ticks)
    if dtype != "float32":
        steps.explain(jrows)
    want = convert.async_state_to_numpy(convert.async_state_from_numpy(
        jax.tree.map(np.asarray, JA.state_to_tree(jstate)), device="cpu"))
    return want, convert.async_state_to_numpy(tstate), jhist, thist, steps


def assert_case_matches(want, got, jhist, thist, steps, *, transport,
                        mixed=False):
    """Every state leaf within the tolerance (the transport's flip share,
    each entry outside within ``steps.allow`` code steps; under the mixed
    policy the float32 leaves' drift); the event records equal (exact
    fields) or within atol 1e-5, rtol 1e-4."""
    drift = 0.0
    if mixed:
        drift = (check.MIXED_DRIFT_PER_STEP * TCFG["inner_lr"]
                 * int(want["counters"]["inner_done"]))
    shares = check.async_mismatch_shares(got, want, H=H, steps=steps,
                                         drift=drift)
    limit = check.MIXED_FLIP_SHARE if mixed and transport != "float32" \
        else check.TRANSPORT_FLIP_SHARE[transport]
    bad = {p: s for p, s in shares.items() if s > limit}
    explained = {p: n for p, n in steps.explained.items() if n}
    if explained:
        print("straddles explained (entries):", explained)
    assert not bad, (bad, explained, steps.unexplained[:20])
    assert len(thist) == len(jhist)
    # a payload whose entries drift by ``drift`` moves its norm by at most
    # drift·sqrt(n)
    n = want["workers"]["0"]["residual"].size
    for t, j in zip(thist, jhist):
        assert sorted(t) == sorted(j), (t, j)
        for key, val in j.items():
            if key in EXACT:
                assert t[key] == val, (key, t, j)
            else:
                atol = 1e-5 + (drift * math.sqrt(n) if key == "delta_norm"
                               else 0.0)
                np.testing.assert_allclose(t[key], val, rtol=1e-4,
                                           atol=atol, err_msg=key)


@pytest.mark.parametrize("dtype,ef,policy", CASES)
def test_async_scenario_a_matches_jax(dtype, ef, policy):
    want, got, jhist, thist, steps = run_case("A", dtype, ef, policy)
    assert_case_matches(want, got, jhist, thist, steps, transport=dtype,
                        mixed=policy is not None)
    assert [r["staleness"] for r in thist] == [0, 0, 2, 1, 0, 2]
    assert ("master" in got["workers"]["0"]) == (policy is not None)


# ---------------------------------------------------------------------------
# engine properties (the port alone)
# ---------------------------------------------------------------------------

def _quad_engine(k=2, H_=2, *, lam=1.0, scenario=None, **dkw):
    """The JAX engine tests' quadratic model over 11 parameters."""
    def loss(p, batch):
        t = batch["tokens"].float().mean() / 7.0
        return (torch.sum((p["w"] - t) ** 2)
                + 0.1 * torch.sum(torch.square(p["b"]))), {}

    sample = lambda g, b, s: torch.randint(0, 7, (b, s), generator=g)
    dcfg = DiLoCoConfig(k=k, H=H_, transport="async", staleness_lambda=lam,
                        **dkw)
    tcfg = TrainConfig(inner_lr=0.05, warmup_steps=2, total_steps=64,
                       batch_size=2, seq_len=4)
    eng = TA.AsyncEngine(loss, sample, dcfg, tcfg, scenario=scenario)
    params = {"w": torch.arange(8.0) / 8.0, "b": torch.ones(3)}
    return eng, params


def test_equal_speed_lambda1_applies_one_round_mass_per_tick():
    """λ=1, equal speeds, float32, no faults: each tick delivers k
    arrivals at weight 1/k, one synchronous round's mass per tick (the
    JAX ``test_async_engine.py`` property)."""
    k = 4
    eng, params = _quad_engine(k, 1, scenario=TF.Scenario.uniform(k))
    state, hist = eng.run(eng.init_state(params), ticks=3)
    by_tick = {}
    for r in hist:
        assert r["event"] == "arrival"
        by_tick.setdefault(r["tick"], []).append(r["weight"])
    assert sorted(by_tick) == [1, 2, 3]
    for ws in by_tick.values():
        assert len(ws) == k and abs(sum(ws) - 1.0) < 1e-12


def test_state_tree_round_trip_is_exact():
    """``state_to_tree`` -> ``state_from_tree`` gives back every leaf bit
    for bit, the counters and the snapshots' versions, and the restored
    state runs on to the same result as the original."""
    eng, params = _quad_engine(
        2, 2, lam=0.7, outer_grad_dtype="int4", error_feedback=True,
        scenario=TF.Scenario(speeds=(1, 3)))
    state, _ = eng.run(eng.init_state(params), ticks=4)
    t = TA.state_to_tree(state)
    back = TA.state_from_tree(tree.map(
        lambda x: x.clone() if torch.is_tensor(x) else x, t),
        state.global_params)
    a, b = convert.async_state_to_numpy(state), \
        convert.async_state_to_numpy(back)
    assert dict(tree.paths(a)).keys() == dict(tree.paths(b)).keys()
    for (p, x), (_, y) in zip(tree.paths(a), tree.paths(b)):
        assert x.dtype == y.dtype and np.array_equal(x, y), p
    assert sorted(back.snapshots) == sorted(state.snapshots)
    s1, h1 = eng.run(state, ticks=8)
    eng2, _ = _quad_engine(
        2, 2, lam=0.7, outer_grad_dtype="int4", error_feedback=True,
        scenario=TF.Scenario(speeds=(1, 3)))
    s2, h2 = eng2.run(back, ticks=8)
    assert h1 == h2
    for x, y in zip(tree.leaves(s1.global_params),
                    tree.leaves(s2.global_params)):
        assert torch.equal(x, y)


def test_snapshots_are_not_aliases():
    """Every snapshot and every worker's params are buffers of their own:
    the outer step updates the global in place."""
    eng, params = _quad_engine(2, 2, lam=0.7,
                               scenario=TF.Scenario(speeds=(1, 3)))
    state, _ = eng.run(eng.init_state(params), ticks=5)
    g = {x.data_ptr() for x in tree.leaves(state.global_params)}
    for s in state.snapshots.values():
        assert not g & {x.data_ptr() for x in tree.leaves(s)}
    for w in state.workers:
        assert not g & {x.data_ptr() for x in tree.leaves(w.params)}
    assert state.live_versions() == set(state.snapshots)


def test_phase_tokens_keyed_by_uid():
    """A phase's tokens come from a generator seeded by (seed, uid): the
    same for any host call order, different across uids and seeds."""
    assert TA.phase_seed(0, 3) == TA.phase_seed(0, 3)
    assert len({TA.phase_seed(s, u) for s in range(3) for u in range(50)}) \
        == 150
    seen = []
    eng, params = _quad_engine(2, 2)
    eng._samplers = tuple(
        lambda g, b, s: seen.append(torch.randint(0, 1 << 30, (1,),
                                                  generator=g).item())
        or torch.zeros((b, s), dtype=torch.long) for _ in range(2))
    eng.run(eng.init_state(params), ticks=2)
    first = list(seen)
    seen.clear()
    eng.run(eng.init_state(params), ticks=2)
    assert seen == first and len(set(first)) == len(first)


def test_engine_validation_matches_jax():
    """The JAX engine's refusals, with its messages; ``make_round`` refuses
    the async transport as JAX's does."""
    loss = lambda p, b: (0.0, {})
    for kw, match in ((dict(outer_grad_dtype="fp8"), "outer_grad_dtype"),
                      (dict(streaming_fragments=2), "streaming_fragments"),
                      (dict(staleness_lambda=1.5), "lambda")):
        with pytest.raises(ValueError, match=match):
            TA.AsyncEngine(loss, None, DiLoCoConfig(k=2, **kw),
                           TrainConfig())
        with pytest.raises(ValueError, match=match):
            JA.AsyncEngine(loss, None, JDCfg(k=2, **kw), JTCfg())
    with pytest.raises(ValueError, match="samplers"):
        TA.AsyncEngine(loss, (None,) * 3, DiLoCoConfig(k=2), TrainConfig())
    for make_round in (TD.make_round, JD.make_round):
        with pytest.raises(ValueError, match="barrier-free"):
            make_round(loss, None, (DiLoCoConfig if make_round is
                                    TD.make_round else JDCfg)(
                transport="async"), TrainConfig())


def test_async_recorder_lines_match_jax():
    """Arrival (with and without an eval: the trailing space), lost,
    leave and join lines, and the records, equal the JAX recorder's."""
    events = [
        {"event": "arrival", "tick": 1, "worker": 0, "uid": 0, "attempt": 0,
         "staleness": 0, "weight": 0.5, "version": 1, "inner_loss": 4.125,
         "delta_norm": 0.5, "wire_bytes": 100.0, "val_loss": 4.0,
         "ppl": math.exp(4.0)},
        {"event": "arrival", "tick": 2, "worker": 1, "uid": 1, "attempt": 1,
         "staleness": 2, "weight": 0.245, "version": 2, "inner_loss": 4.0,
         "delta_norm": 0.25, "wire_bytes": 100.0},
        {"event": "lost", "tick": 3, "worker": 1, "uid": 2,
         "version_at_dispatch": 2, "inner_loss": 3.5},
        {"event": "leave", "tick": 3, "worker": 1},
        {"event": "join", "tick": 5, "worker": 1, "version": 4}]
    said = {"jax": [], "torch": []}
    recs = {"jax": jmetrics.RunRecorder(
        transport="async", printer=lambda s, **_: said["jax"].append(s)),
            "torch": tmetrics.RunRecorder(
        transport="async", printer=lambda s, **_: said["torch"].append(s))}
    for rec in recs.values():
        for ev in events:
            rec.async_event(dict(ev))
    assert said["torch"] == said["jax"]
    assert said["torch"][1].endswith(" ")
    assert recs["torch"].records == recs["jax"].records
    assert recs["torch"].wire_bytes_total == recs["jax"].wire_bytes_total


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

ASYNC_FLAGS = ["--device", "cpu", "--transport", "async", "--speeds", "1,2",
               "--staleness-lambda", "0.7", "--outer-grad-dtype", "int4",
               "--error-feedback", "--k", "2", "--H", "2", "--rounds", "2",
               "--batch", "2", "--seq", "32", "--eval-batch", "2"]


def test_async_cli_runs_on_cpu(tmp_path):
    """``--transport async`` trains on the CPU: 6 arrivals over the 4 ticks
    of 2 barrier rounds at speeds (1, 2), the JAX console lines, the wire
    plan and the packed int4 bytes per apply."""
    said = []
    rec = tmetrics.RunRecorder(transport="async",
                               printer=lambda s, **_: said.append(s))
    out = tmp_path / "run.json"
    args = train.make_parser().parse_args(ASYNC_FLAGS + ["--out",
                                                         str(out)])
    records = train.run(args, recorder=rec)
    assert [r["staleness"] for r in records] == [0, 0, 2, 1, 0, 2]
    assert [(r["tick"], r["worker"]) for r in records] == [
        (1, 0), (2, 0), (2, 1), (3, 0), (4, 0), (4, 1)]
    for r in records:
        assert r["phase"] == "diloco_async" and r["transport"] == "async"
        assert math.isfinite(r["inner_loss"]) and math.isfinite(
            r["val_loss"])
    n = sum(x.numel() for x in tree.leaves(treg.get_smoke_arch(
        "diloco_150m").init(generator=None, device="meta")))
    assert records[0]["wire_bytes"] == float(
        -(-n // 2) + (-(-(-n // 2)) % 4) + 4 * -(-n // 128))
    assert said[0] == (f"async transport: lambda=0.7 k=2 4 tick(s), "
                       f"{records[0]['wire_bytes']} B/apply")
    assert said[1].startswith("[tick 1] worker 0 stale=0 w=0.500 inner=")
    assert said[-2].startswith("done in ") and "6 applications over 4 " \
        "ticks; entropy floor = " in said[-2]
    assert rec.manifest["wire_plan"] == [
        {"fragment": 0, "wire_bytes": records[0]["wire_bytes"],
         "wire_dtype": "int4"}]
    assert len(rec.manifest["timing"]["events"]) == 6
    assert out.exists()


@pytest.mark.parametrize("flags,named", [
    (["--stream-fragments", "2"], "--stream-fragments do"),
    (["--stream-alpha", "0.5", "--stream-tau", "1"],
     "--stream-alpha, --stream-tau do"),
    (["--cosine-stats"], "--cosine-stats do"),
    (["--legacy-loop"], "--legacy-loop do"),
    (["--speeds", "1,2,3"], "--speeds needs 1 or k=2 values"),
    (["--preempt", "0"], "--preempt wants WORKER:LEAVE"),
])
def test_async_cli_validation_matches_jax(flags, named):
    """The JAX trainer's validation of the async flags, with its
    messages."""
    args = train.make_parser().parse_args(ASYNC_FLAGS + flags)
    with pytest.raises(SystemExit, match=named):
        train.run(args)


SHARDED = ["--transport", "sharded", "--pods", "2", "--stream-fragments",
           "2"]


# ``--trace`` on the async transport was refused as unported telemetry
# until the telemetry slice ported it: it now writes the event timeline's
# trace, which both packages' validators accept and whose transfer spans
# match the engine's events exactly once
@pytest.mark.parametrize("flags,named", [
    (["--transport", "async", "--trace", "t.json"], "telemetry"),
])
def test_still_unported_flags_name_their_item(flags, named, tmp_path):
    from repro.obs import trace as jtrace
    from repro_torch.obs import trace as ttrace
    flags = [str(tmp_path / f) if f.endswith(".json") else f for f in flags]
    argv = ASYNC_FLAGS + ["--ticks", "3"] + flags
    args = train.make_parser().parse_args(argv)
    records = train.run(args, recorder=tmetrics.RunRecorder(
        transport="async", printer=lambda *a, **k: None))
    trace = json.loads((tmp_path / "t.json").read_text())
    assert ttrace.validate_trace(trace) == []
    assert jtrace.validate_trace(trace) == []
    events = [r for r in records if r["kind"] == "event"]
    assert ttrace.span_event_correspondence(trace, events) == []
    assert ttrace.trace_wire_bytes(trace) == pytest.approx(
        sum(r["wire_bytes"] for r in events if r["event"] == "arrival"))


# the cases the test above refused until the gossip transport and the
# sharded transport's resilience flags were ported: each now runs (the
# sharded guard, state hash and checkpoint in this process, the crash in
# a subprocess, which it kills)
@pytest.mark.parametrize("flags", [
    ["--gossip-pairing", "random"], ["--transport", "gossip"],
    SHARDED + ["--crash-at-round", "0"], SHARDED + ["--guard"],
    SHARDED + ["--state-hash-out", "h.json"],
    SHARDED + ["--checkpoint", "c.npz"]])
def test_formerly_unported_flags_run(flags, tmp_path):
    flags = [str(tmp_path / f) if f.endswith((".json", ".npz")) else f
             for f in flags]
    argv = ["--device", "cpu", "--k", "2", "--H", "2", "--rounds", "1",
            "--batch", "2", "--seq", "16", "--eval-batch", "2", *flags]
    if "--crash-at-round" in flags:
        proc = harness.run_until_crash(argv, timeout=600)
        assert "crash: SIGKILL at round boundary 1" in proc.stdout
        return
    records = train.run(train.make_parser().parse_args(argv),
                        recorder=tmetrics.RunRecorder(
                            printer=lambda *a, **kw: None))
    assert [r["round"] for r in records if r["kind"] == "round"] == [1]
    for f in flags:
        if f.endswith(".json"):
            assert len(json.loads(Path(f).read_text())["state_sha256"]) \
                == 64
        if f.endswith(".npz"):
            assert Path(f).stat().st_size > 0


def test_scenario_on_round_transport():
    """On the simulated transport a fault scenario replaces the i.i.d.
    drop masks and multiplies the active masks, as the JAX trainer
    projects it: worker 1 preempted over round 1 is inactive there."""
    rec = tmetrics.RunRecorder(printer=lambda s, **_: None)
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--k", "2", "--H", "1", "--rounds", "3",
         "--batch", "2", "--seq", "16", "--eval-batch", "2", "--speeds",
         "1,2", "--preempt", "1:2:4"])
    records = train.run(args, recorder=rec)
    drops, acts = JF.Scenario(speeds=(1, 2), preemptions=((1, 2, 4),)
                              ).round_masks(2, 3)
    assert [r["active"] for r in records] == [int(a.sum()) for a in acts]
    assert [r["active"] for r in records] == [2, 1, 2]
    assert rec.manifest["notes"][0]["note"] == (
        "faults: barrier round = 2 tick(s) (slowest worker + slowest link)")


def test_run_async_one_call_api():
    """``run_async`` returns the global params and the arrival records of
    a fault-free run (all records under a faulty scenario), as JAX's."""
    eng, params = _quad_engine(2, 2)
    acfg = TA.AsyncConfig(k=2, H=2, staleness_lambda=0.7, speeds=(1, 2))
    g, hist = TA.run_async(eng.loss_fn, lambda gen, b, s: torch.zeros(
        (b, s), dtype=torch.long), params, acfg, eng.tcfg, ticks=4,
        donate=False)
    assert [r["staleness"] for r in hist] == [0, 0, 2, 1, 0, 2]
    assert sorted(g) == ["b", "w"] and torch.isfinite(g["w"]).all()
    _, hist = TA.run_async(
        eng.loss_fn, lambda gen, b, s: torch.zeros((b, s), dtype=torch.long),
        params, acfg, eng.tcfg, ticks=8,
        scenario=TF.Scenario(speeds=(1, 2), preemptions=((1, 3, 5),)))
    assert {"leave", "join"} <= {r["event"] for r in hist}
