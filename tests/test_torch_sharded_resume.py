"""Snapshots, resume, the scripted crash and the guard on the port's
sharded transport (``launch/train.py``, ``launch/mesh.py``,
``core/pod_collectives.py``), on gloo ranks on the CPU.

A sharded rank holds only its band of replicas. A snapshot gathers the
bands on rank 0, which writes the full state at host placement; a resume
loads it on every rank and bands it for the run's own ``--pods``, so a
snapshot taken under pods=2 resumes under pods=4 (the elastic path).
These tests show:

- placement alone round-trips: a state after a τ=1 int4 round, with a
  deferred gather still in flight, written under pods=2, loaded and
  banded under pods=4 and gathered again, is the same file bit for bit;
- a crash at a round boundary SIGKILLs every rank and then the trainer
  (exit -9, no rank left), and ``--resume auto`` ends at the uncut run's
  ``state_sha256``;
- a resume under ``--pods 4`` of a pods=2 snapshot ends bit for bit at
  the uncut pods=2 run's state: the replicas' work does not depend on
  which rank holds them, the packed int4 reduce sums the gathered wires
  in replica order on every rank, and each rank draws every shard's
  tokens (the CPU ranks' thread counts differ and still agree);
- the guard's rollback, decided on rank 0 for every rank, finishes
  without a deadlock and logs the guard events of the port's simulated
  streaming run with the same flags and of the JAX trainer's; the loss
  goes non-finite under ``--inner-lr 1e30`` (NaN bombs stay refused off
  the classic transport, as in JAX);
- ``--resume`` of a snapshot of another k is refused.

The trainers run in this process through ``train.run``, the crash in a
subprocess (a real SIGKILL).
"""
from __future__ import annotations

import uuid
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro.launch import train as jtrain  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import resilience  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.resilience import harness  # noqa: E402

torch.set_num_threads(2)
SIZES = ["--device", "cpu", "--H", "2", "--batch", "2", "--seq", "32",
         "--eval-batch", "2", "--rounds-per-call", "2"]
STREAM = ["--stream-fragments", "2", "--stream-tau", "1", "--stream-alpha",
          "0.5", "--outer-grad-dtype", "int4", "--error-feedback"]
SHARDED = ["--transport", "sharded", *STREAM]
TINY = dict(name="tiny", family="dense", n_layers=4, d_model=40, n_heads=2,
            n_kv_heads=2, d_ff=72, vocab_size=64, remat=False, attn_chunk=32)


def _run(flags, recorder=None):
    args = train.make_parser().parse_args(SIZES + flags)
    rec = recorder or tmetrics.RunRecorder(printer=lambda *a, **kw: None)
    return train.run(args, recorder=rec), rec


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: np.array(data[k]) for k in data.files}


def test_snapshot_rebands_under_more_pods_bit_for_bit(tmp_path):
    """A pods=2 snapshot with a gather in flight, banded over 4 ranks and
    gathered back with no round between, equals the file bit for bit."""
    K, H, B, S = 4, 2, 2, 16
    cfg = ModelConfig(**TINY)
    dcfg = DiLoCoConfig(k=K, H=H, streaming_fragments=2, stream_tau=1,
                        stream_alpha=0.5, outer_grad_dtype="int4",
                        error_feedback=True, transport="sharded")
    tcfg = TrainConfig(batch_size=B, seq_len=S, inner_lr=3e-3,
                       warmup_steps=2, total_steps=2 * H)
    gen = torch.Generator().manual_seed(0)
    params = treg.Arch(cfg=cfg).init(generator=gen, device="cpu")
    toks = torch.randint(0, 64, (1, K, H * B, S), generator=gen)
    ones = np.ones(K, np.float32)
    snap, back = str(tmp_path / "snap.npz"), str(tmp_path / "back.npz")
    res = mesh.spawn("repro_torch.launch.pod_rounds:rounds",
                     mesh.make_pod_layout(2, "cpu"), cfg, dcfg, tcfg, toks,
                     [(ones, ones, ones / K)], params, None, snap)
    assert all(r["unwaited"] > 0 for r in res)      # a gather in flight
    bands = mesh.spawn("repro_torch.launch.pod_rounds:reband",
                       mesh.make_pod_layout(4, "cpu"), cfg, dcfg, snap, back)
    assert bands == [1, 1, 1, 1]
    want, got = _npz(snap), _npz(back)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("state//inflight") for k in want)
    for key, a in want.items():
        b = got[key]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), key
        assert a.tobytes() == b.tobytes(), key


def test_crash_kills_every_rank_and_resume_auto_matches(tmp_path):
    """``--crash-at-round 2`` (the chunk after the round-2 snapshot) kills
    both ranks and the trainer by SIGKILL with no rank left;
    ``--resume auto`` picks the round-2 snapshot up and ends at the uncut
    run's state."""
    base = SHARDED + ["--pods", "2", "--k", "2", "--rounds", "4",
                      "--checkpoint-every", "2", "--retain", "1"]
    uncut = str(tmp_path / "uncut.json")
    _run(base + ["--checkpoint-dir", str(tmp_path / "u"),
                 "--state-hash-out", uncut])
    ck = str(tmp_path / "c")
    tag = uuid.uuid4().hex
    proc = harness.run_until_crash(
        SIZES + base + ["--checkpoint-dir", ck, "--crash-at-round", "2"],
        timeout=600, env={"REPRO_CRASH_TEST": tag})
    assert proc.returncode == harness.SIGKILL_RC
    assert "crash: SIGKILL at round boundary 3" in proc.stdout
    assert harness.processes_with("REPRO_CRASH_TEST", tag) == []
    assert resilience.CheckpointManager(ck).steps() == [2]
    resumed = str(tmp_path / "resumed.json")
    records, rec = _run(base + ["--checkpoint-dir", ck, "--resume", "auto",
                                "--state-hash-out", resumed])
    want, got = harness.read_json(uncut), harness.read_json(resumed)
    assert got["resumed_from_step"] == 2
    assert [r["round"] for r in rec.round_records()] == [3, 4]
    assert got["state_sha256"] == want["state_sha256"], sorted(
        k for k, v in got["leaf_sha256"].items()
        if want["leaf_sha256"][k] != v)
    load = rec.manifest["timing"]["loads"][0]
    assert load["step"] == 2 and load["band_s"] >= 0


def test_resume_under_four_pods_matches_the_uncut_two_pod_run(tmp_path):
    """k=4: the round-2 snapshot of a pods=2 run, resumed with ``--pods
    4``, ends bit for bit at the uncut pods=2 run's state; the snapshot
    does not count as wire traffic."""
    base = SHARDED + ["--k", "4", "--rounds", "4", "--checkpoint-every",
                      "2", "--checkpoint-dir", str(tmp_path / "d")]
    uncut, resumed = str(tmp_path / "u.json"), str(tmp_path / "r.json")
    _, rec = _run(base + ["--pods", "2", "--state-hash-out", uncut])
    plain, _ = _run(SHARDED + ["--k", "4", "--rounds", "4", "--pods", "2"])
    _, rec4 = _run(base + ["--pods", "4", "--resume", "2",
                           "--state-hash-out", resumed])
    want, got = harness.read_json(uncut), harness.read_json(resumed)
    assert got["state_sha256"] == want["state_sha256"], sorted(
        k for k, v in got["leaf_sha256"].items()
        if want["leaf_sha256"][k] != v)
    ranks = rec.manifest["ranks"]
    per_round = sum(p["wire_bytes"] for p in rec.manifest["wire_plan"])
    for r in ranks:                 # k_loc = 2 replicas, 4 rounds
        assert r["traffic"]["wire_bytes"] == 2 * 4 * per_round
        assert r["traffic"]["control"] > 0
    assert [r["rank"] for r in rec4.manifest["ranks"]] == [0, 1, 2, 3]
    snaps = rec.manifest["timing"]["snapshots"]
    assert [s["step"] for s in snaps] == [2, 4]
    assert all(s["gather_s"] >= 0 and s["bytes"] > 0 for s in snaps)
    assert [r["val_loss"] for r in plain] == [r["val_loss"] for r in
                                              rec.round_records()]


GUARD = ["--k", "2", "--rounds", "4", "--inner-lr", "1e30", "--warmup",
         "4", "--guard", "--checkpoint-every", "1"]


def _events(records) -> list:
    return [(r["event"], r["round"]) for r in records
            if r["kind"] == "event"]


def test_guard_rollback_decided_on_rank_zero(tmp_path):
    """Under ``--inner-lr 1e30`` the round-2 losses are NaN: rank 0's
    guard rolls every rank back to the round-1 snapshot twice (its
    budget), then lets the run go on; the run ends (no deadlock) with the
    guard events of the simulated streaming run and of the JAX
    trainer."""
    sharded, rec = _run(SHARDED + GUARD + [
        "--pods", "2", "--checkpoint-dir", str(tmp_path / "s"),
        "--state-hash-out", str(tmp_path / "s.json")])
    simulated, _ = _run(STREAM + GUARD + ["--checkpoint-dir",
                                          str(tmp_path / "m")])
    jargs = jtrain.make_parser().parse_args(
        SIZES[2:] + STREAM + GUARD + ["--checkpoint-dir",
                                      str(tmp_path / "j")])
    jax_records = jtrain.run(jargs, recorder=jmetrics.RunRecorder(
        printer=lambda *a, **kw: None))
    want = [("anomaly", 1), ("rollback", 1)] * 2 + [
        ("anomaly", 1), ("anomaly", 2), ("anomaly", 3)]
    assert _events(sharded) == want
    assert _events(simulated) == want
    assert _events(jax_records) == want
    assert harness.read_json(str(tmp_path / "s.json"))["rollbacks"] == 2
    assert [ld["step"] for ld in rec.manifest["timing"]["loads"]] == [1, 1]


def test_resume_with_another_k_is_refused(tmp_path):
    """A snapshot's k (its metadata) must be the run's ``--k``; the
    refusal names both, before any rank starts."""
    mgr = resilience.CheckpointManager(str(tmp_path / "d"))
    mgr.save(2, {"w": torch.zeros(3)}, metadata={"k": 2, "rounds_done": 2})
    args = train.make_parser().parse_args(
        SIZES + SHARDED + ["--k", "4", "--pods", "2", "--rounds", "4",
                           "--checkpoint-dir", str(tmp_path / "d"),
                           "--resume", "2"])
    with pytest.raises(SystemExit, match="k=2 replicas and this run has "
                                         "--k 4"):
        train.run(args)
    assert Path(mgr.path_of(2)).exists()
