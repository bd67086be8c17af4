"""The port's sharded transport (``core/pod_collectives.py``,
``launch/mesh.py``, the sharded branch of ``core/streaming.py``) against
the JAX package's sharded transport, on gloo ranks on the CPU.

The ranks are processes of the port's own (``launch/mesh.spawn`` running
``launch/pod_rounds.rounds``; a spawned child imports its target's
module, so the target lives in the package, which imports no JAX). One
int4 round with error feedback (P=2, τ=1, α=0.5, the packed wire, a
dropped and an inactive replica, uneven weights) runs on k=4 replicas
banded over 2 pods, from the JAX ``init_state`` and on the tokens the JAX
sampler draws, against the JAX sharded round on the 8 fake CPU devices
of ``tests/conftest.py`` (``pods`` = 2 mesh slices). Every ``StreamState``
field is held by ``check.stream_mismatch_shares``: float32 leaves atol
1e-5, rtol 1e-4, at most ``check.TRANSPORT_FLIP_SHARE["int4"]`` (0.1 %)
of a leaf's entries outside (an upstream last-bit difference may flip an
int4 code). The packed in-flight wire of the fragment whose apply wraps
into the next round is compared decoded, by value. The round metrics
agree within atol 1e-5, rtol 1e-4 and the stream byte counts exactly.

The same run shows: the state every rank holds in full (global params,
outer state, pending, armed, in-flight) is bit for bit the same on both
ranks; the bytes the ranks hand to ``torch.distributed`` for the outer
gradients equal ``sync_plan``'s packed accounting (k_loc replicas ×
the plan's bytes per send), with exactly one gather per fragment per
sync. The trainer runs the whole command on the CPU and refuses what the
JAX trainer refuses.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import ModelConfig as JMCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.core import pod_collectives as JPC  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402
from repro_torch.core.pod_collectives import PodGroup  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402

torch.set_num_threads(2)
K, PODS, H, B, S, VOCAB = 4, 2, 4, 2, 16, 64
TINY = dict(name="tiny", family="dense", n_layers=4, d_model=40, n_heads=2,
            n_kv_heads=2, d_ff=72, vocab_size=VOCAB, remat=False,
            attn_chunk=32)
KW = dict(k=K, H=H, streaming_fragments=2, stream_tau=1, stream_alpha=0.5,
          outer_grad_dtype="int4", error_feedback=True, transport="sharded")
DROP = np.array([1, 0, 1, 1], np.float32)
ACT = np.array([1, 1, 1, 0], np.float32)
WEIGHTS = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module")
def jax_vs_port():
    """One sharded round in both packages from the JAX initial state.
    Returns (JAX state and metrics in the port's numpy form, the ports'
    per-rank results, the port's DiLoCoConfig)."""
    jarch = jreg.Arch(cfg=JMCfg(**TINY))
    params, _ = jarch.init(jax.random.PRNGKey(0), jarch.cfg)
    sampler = JMarkov(vocab_size=VOCAB, k=K, seed=0)
    jd = JDCfg(kernel_mode="ref", **KW)
    jt = JTCfg(kernel_mode="ref", batch_size=B, seq_len=S, inner_lr=3e-3,
               warmup_steps=2, total_steps=2 * H)
    jstate0 = JS.init_state(params, jd)
    mesh_ = jmesh.make_mesh((PODS, 8 // PODS), ("pod", "data"))
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b),
                         sampler.sample_all_shards, jd, jt, batch_size=B,
                         seq_len=S, mesh=mesh_)
    jstate, jm = jrnd(JPC.shard_stream_state(jstate0, mesh_),
                      jax.random.PRNGKey(10), jnp.asarray(DROP),
                      jnp.asarray(ACT), jnp.asarray(WEIGHTS))
    # the round's tokens as the JAX round draws them
    keys = jax.random.split(jax.random.PRNGKey(10), H)
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(keys), 0, 1)[:K])
    tdcfg = DiLoCoConfig(**KW)
    full0 = convert.stream_state_from_numpy(
        jax.tree.map(np.asarray, jstate0), tdcfg, device="cpu")
    results = mesh.spawn(
        "repro_torch.launch.pod_rounds:rounds",
        mesh.make_pod_layout(PODS, "cpu"), ModelConfig(**TINY), tdcfg,
        TrainConfig(batch_size=B, seq_len=S, inner_lr=3e-3, warmup_steps=2,
                    total_steps=2 * H),
        torch.from_numpy(toks).long().reshape(1, K, H * B, S),
        [(DROP, ACT, WEIGHTS)], None, full0)
    want = convert.stream_state_to_numpy(convert.stream_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tdcfg, device="cpu"), tdcfg)
    return want, jm, results, tdcfg, full0, jax.tree.map(np.asarray, jstate)


def test_sharded_round_matches_jax(jax_vs_port):
    want, jm, results = jax_vs_port[:3]
    got = results[0]["state"]
    assert "inflight" in got and got["inflight"]
    shares = check.stream_mismatch_shares(got, want, H=H)
    bad = {p: s for p, s in shares.items()
           if s > check.TRANSPORT_FLIP_SHARE["int4"]}
    assert not bad, bad
    tm = results[0]["metrics"][0]
    for name in ("inner_loss", "inner_loss_last", "outer_gnorm",
                 "drop_frac"):
        np.testing.assert_allclose(tm[name], float(jm[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    for name in ("stream_peak_sync_bytes", "stream_round_sync_bytes"):
        assert tm[name] == float(jm[name]), name


def test_shared_state_identical_on_every_rank(jax_vs_port):
    results = jax_vs_port[2]
    assert len({r["shared"] for r in results}) == 1
    assert results[1]["state"] is None


def test_wire_bytes_equal_the_packed_plan(jax_vs_port):
    """The bytes handed to ``torch.distributed`` for the outer gradients
    equal the packed accounting of ``sync_plan`` (which equals the JAX
    plan), one ``gather_wire`` per fragment per sync and no other wire
    collective; the round's stream metrics are the plan's."""
    results, tdcfg, full0 = jax_vs_port[2:5]
    plan = TS.sync_plan(full0.global_params, tdcfg)
    jplan = JS.sync_plan(jax.tree.map(
        np.asarray, _jax_params()), JDCfg(**KW))
    assert [(p["wire_bytes"], p["packed"], p["deferred"]) for p in plan] \
        == [(p["wire_bytes"], p["packed"], p["deferred"]) for p in jplan]
    assert all(p["packed"] and p["deferred"] for p in plan)
    sends = len(plan)                    # one round: each fragment once
    for r in results:
        t = r["traffic"]
        assert t["gather_wire"] == sends and t["all_gather"] == 0
        assert t["wire_bytes"] == (K // PODS) * sum(p["wire_bytes"]
                                                    for p in plan)
        assert t["all_reduce"] == 2 and t["metric_bytes"] == 8
    m = results[0]["metrics"][0]
    assert m["stream_round_sync_bytes"] == sum(p["wire_bytes"] for p in plan)
    assert m["stream_peak_sync_bytes"] == max(p["wire_bytes"] for p in plan)


def test_deferred_gather_waited_at_the_apply(jax_vs_port):
    """A deferred send issues its gather and parks the handle: the
    fragment whose apply falls in the next round ends the round with its
    gather not yet waited for, the one applied within the round was."""
    results, tdcfg, full0 = jax_vs_port[2:5]
    plan = TS.sync_plan(full0.global_params, tdcfg)
    crossing = sum(p["crosses_round"] for p in plan)
    assert 0 < crossing < len(plan)
    assert all(r["unwaited"] == crossing for r in results)


def test_jax_sharded_state_bands_per_rank(jax_vs_port):
    """``convert.sharded_state_from_numpy``: the JAX sharded state after
    the round, banded for each rank: its replicas' leaves exactly the JAX
    state's band, the shared leaves whole, the packed in-flight wire
    byte for byte."""
    tdcfg, jnp_state = jax_vs_port[3], jax_vs_port[5]
    k_loc = K // PODS
    for rank in range(PODS):
        st = convert.sharded_state_from_numpy(
            jnp_state, tdcfg, PodGroup(rank, PODS, device="cpu",
                                       backend="gloo"))
        band = slice(rank * k_loc, (rank + 1) * k_loc)
        for name, got_t, want_t in (
                ("replica_params", st.base.replica_params,
                 jnp_state.base.replica_params),
                ("m", st.base.inner_state.m, jnp_state.base.inner_state.m),
                ("residual", st.residual, jnp_state.residual)):
            for (path, a), (_, b) in zip(tree.paths(got_t),
                                         tree.paths(want_t)):
                np.testing.assert_array_equal(a.numpy(), b[band],
                                              err_msg=f"{name}.{path}")
        np.testing.assert_array_equal(st.base.inner_state.count,
                                      jnp_state.base.inner_state.count[band])
        for (path, a), (_, b) in zip(tree.paths(st.global_params),
                                     tree.paths(jnp_state.base
                                                .global_params)):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
        for slot, jslot in zip(st.inflight, jnp_state.inflight):
            np.testing.assert_array_equal(slot[0].numpy(), jslot[0])


def _jax_params():
    jarch = jreg.Arch(cfg=JMCfg(**TINY))
    return jarch.init(jax.random.PRNGKey(0), jarch.cfg)[0]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_sharded_cli_runs_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --transport sharded --pods 2``
    is the whole command: it starts its ranks, rank 0 prints the rounds
    and the backend note, the --out file holds every rank's counts."""
    out = tmp_path / "run.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--transport", "sharded", "--pods", "2", "--stream-fragments", "2",
         "--stream-tau", "1", "--stream-alpha", "0.5", "--outer-grad-dtype",
         "int4", "--error-feedback", "--k", "2", "--H", "2", "--rounds", "2",
         "--batch", "2", "--seq", "32", "--eval-batch", "2", "--out",
         str(out)], env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == ("sharded transport: 2 pods × 1 replicas/pod on the "
                        "CPU; backend gloo (ranks on the CPU; no host "
                        "staging)")
    assert sum(ln.startswith("[round") for ln in lines) == 2
    assert lines[-1] == f"wrote {out}"
    run = json.loads(out.read_text())
    plan = run["manifest"]["wire_plan"]
    ranks = run["manifest"]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    per_round = sum(p["wire_bytes"] for p in plan)
    for r in ranks:
        assert r["traffic"]["gather_wire"] == 2 * len(plan)
        assert r["traffic"]["wire_bytes"] == 2 * per_round
    for rec in run["history"]:
        assert rec["stream_round_sync_bytes"] == per_round
        assert np.isfinite(rec["inner_loss"]) and np.isfinite(
            rec["val_loss"])


def test_a_failing_rank_fails_the_run():
    """An error inside a rank (here the streaming round's refusal of a
    non-Nesterov outer optimizer) fails the run."""
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--transport", "sharded", "--pods", "2",
         "--stream-fragments", "2", "--outer-opt", "sgd", "--k", "2",
         "--H", "2", "--rounds", "1", "--batch", "2", "--seq", "16",
         "--eval-batch", "2"])
    with pytest.raises(Exception, match="nesterov"):
        train.run(args, recorder=tmetrics.RunRecorder(
            printer=lambda *a, **kw: None))


@pytest.mark.parametrize("flags,named,jax_too", [
    (["--pods", "2", "--stream-fragments", "2"],
     "--pods requires --transport sharded", True),
    (["--transport", "sharded"], "--transport require", True),
    (["--transport", "sharded", "--no-pack-wire"],
     "--transport, --no-pack-wire require", True),
    (["--transport", "async", "--pods", "2"], "--pods do", True),
    (["--transport", "sharded", "--stream-fragments", "2", "--pods", "1"],
     "needs >= 2 pods", False),
    (["--transport", "sharded", "--stream-fragments", "2",
      "--cosine-stats"], "--cosine-stats", False),
])
def test_sharded_refusals_match_jax(flags, named, jax_too):
    """The JAX trainer's refusals of the sharded flags, with its messages
    (``jax_too``: the JAX trainer's ``build`` refuses the same flags)."""
    args = train.make_parser().parse_args(["--device", "cpu", "--k", "2",
                                           *flags])
    with pytest.raises(SystemExit, match=named):
        train.run(args)
    if jax_too:
        with pytest.raises(SystemExit, match=named):
            jtrain.build(jtrain.make_parser().parse_args(["--k", "2",
                                                          *flags]))


def test_pods_must_divide_k():
    args = train.make_parser().parse_args(
        ["--device", "cpu", "--transport", "sharded", "--stream-fragments",
         "2", "--k", "3", "--pods", "2"])
    with pytest.raises(ValueError, match="cannot be banded over 2 pods"):
        train.run(args)


def test_default_pods_and_layout():
    """JAX's default pod count (the largest p >= 2 that bands k and tiles
    the devices; the port's ranks may share a card), and the backend the
    layout implies."""
    assert mesh.default_pods(8, 1) == 8
    assert mesh.default_pods(8, 4) == 8
    assert mesh.default_pods(6, 4) == 2
    assert mesh.default_pods(4, 6) == 2
    assert mesh.default_pods(1, 1) == 1
    cpu = mesh.make_pod_layout(4, "cpu")
    assert (cpu.backend, cpu.staged, cpu.devices) == ("gloo", False,
                                                      ("cpu",) * 4)
    assert mesh.chips_of(cpu) == 1
