"""Crash and resume of the port's trainer on the CPU: a run killed by
``--crash-at-round`` (a real SIGKILL, in a subprocess) and resumed with
``--resume auto`` ends in the uncut run's state, bit for bit
(``--state-hash-out``), on the synchronous and the streaming transport;
a truncated newest snapshot makes the resume fall back to the one before
it; the async engine, cut by ``--crash-at-tick`` and resumed, or restored
from a snapshot by ``--restore``, ends where the uncut run does; ``--legacy-loop`` and the
chunked driver print the same numbers; a snapshot of the JAX package is
refused by ``--resume`` with a message that says so.
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.resilience import harness  # noqa: E402

torch.set_num_threads(2)
BASE = ["--device", "cpu", "--k", "2", "--H", "2", "--batch", "2",
        "--seq", "32", "--eval-batch", "2"]
ROUNDS = ["--rounds", "6", "--rounds-per-call", "2"]
STREAM = ["--stream-fragments", "2", "--stream-tau", "1", "--stream-alpha",
          "0.5", "--outer-grad-dtype", "int4", "--error-feedback"]
ASYNC = ["--transport", "async", "--speeds", "1,2", "--ticks", "8",
         "--outer-grad-dtype", "int4", "--error-feedback"]


@pytest.fixture(autouse=True)
def _two_threads(monkeypatch):
    """The trainer subprocesses inherit the environment: two threads each,
    as this process runs."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


def _run(argv):
    """The trainer in this process; returns its records."""
    rec = tmetrics.RunRecorder(printer=lambda *a, **kw: None)
    return train.run(train.make_parser().parse_args(argv), recorder=rec)


def _hash(tmp_path, name, argv) -> dict:
    out = str(tmp_path / f"{name}.json")
    _run(argv + ["--state-hash-out", out])
    return json.loads(open(out).read())


@pytest.mark.parametrize("extra", [[], STREAM], ids=["sync", "stream"])
def test_crash_then_resume_matches_uncut(tmp_path, extra):
    argv = BASE + ROUNDS + extra
    uncut = _hash(tmp_path, "uncut", argv)
    snap = ["--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2"]
    proc = harness.run_until_crash(argv + snap + ["--crash-at-round", "2"],
                                   timeout=300)
    assert "crash: SIGKILL at round boundary 3" in proc.stdout
    resumed = _hash(tmp_path, "resumed", argv + snap + ["--resume", "auto"])
    assert resumed["resumed_from_step"] == 2
    assert resumed["state_sha256"] == uncut["state_sha256"]
    assert resumed["final_val_loss"] == uncut["final_val_loss"]
    assert resumed["ingest_calls"] == 2 and uncut["ingest_calls"] == 3


def test_truncated_latest_snapshot_falls_back(tmp_path):
    argv = BASE + ROUNDS
    uncut = _hash(tmp_path, "uncut", argv)
    snap = ["--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2"]
    harness.run_until_crash(argv + snap + ["--crash-at-round", "4"],
                            timeout=300)
    assert harness.corrupt_latest(str(tmp_path / "ck")).endswith(
        "ckpt_00000004.npz")
    resumed = _hash(tmp_path, "resumed", argv + snap + ["--resume", "auto"])
    assert resumed["resumed_from_step"] == 2
    assert resumed["state_sha256"] == uncut["state_sha256"]


def test_async_crash_and_restore_match_uncut(tmp_path):
    """Cut by a SIGKILL at tick 5 (a snapshot every 2 events) and resumed
    with ``--resume auto``, or restarted from the oldest snapshot left with
    ``--restore`` (a snapshot is the whole engine state, as ``--checkpoint``
    writes it): each phase draws its tokens from its own (seed, uid)
    generator, so both end in the uncut run's state."""
    argv = BASE + ASYNC
    uncut = _hash(tmp_path, "uncut", argv)
    snap = ["--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "2"]
    proc = harness.run_until_crash(argv + snap + ["--crash-at-tick", "5"],
                                   timeout=300)
    assert "[tick 5] crash" in proc.stdout
    oldest = ckpt.load_metadata(
        str(sorted((tmp_path / "ck").glob("ckpt_*.npz"))[0]))
    resumed = _hash(tmp_path, "resumed", argv + snap + ["--resume", "auto"])
    assert resumed["resumed_from_step"] > oldest["events_done"] > 0
    assert resumed["state_sha256"] == uncut["state_sha256"]
    first = str(sorted((tmp_path / "ck").glob("ckpt_*.npz"))[0])
    restored = _hash(tmp_path, "restored", argv + ["--restore", first])
    assert restored["state_sha256"] == uncut["state_sha256"]


def test_legacy_loop_and_chunked_driver_agree(tmp_path):
    """The same flags through --legacy-loop and the chunked driver: the
    same inner and val losses every round, the same final state."""
    argv = BASE + ROUNDS + ["--drop-prob", "0.3"]
    out = {}
    for name, extra in (("chunked", []), ("legacy", ["--legacy-loop"])):
        path = str(tmp_path / f"{name}.json")
        recs = _run(argv + extra + ["--state-hash-out", path])
        out[name] = ([(r["inner_loss"], r["val_loss"], r["dropped"])
                      for r in recs], json.load(open(path))["state_sha256"])
    assert out["legacy"] == out["chunked"]


def test_jax_snapshot_refused_by_resume(tmp_path):
    """A snapshot the JAX package wrote verifies (same manifest) but holds
    a jax.random key: --resume exits and names the JAX package."""
    params, _ = jreg.get_smoke_arch("diloco_150m").init(
        jax.random.PRNGKey(0))
    state = JD.init_state(params, JDCfg(k=2))
    jres.CheckpointManager(str(tmp_path)).save(
        2, jres.wrap(state, jax.random.PRNGKey(1), 2))
    with pytest.raises(SystemExit, match="written by the JAX package"):
        _run(BASE + ROUNDS + ["--checkpoint-dir", str(tmp_path),
                              "--resume", "2"])
