"""Two faults of the port's drivers against the JAX package's, repaired:

1. The round transports report a val loss on the rounds the JAX trainer
   evaluates: every round under ``--legacy-loop``; under
   ``--rounds-per-call N`` the ``--eval-every`` rounds and the last round
   of every chunk of N; by default (all rounds in one call) the
   ``--eval-every`` rounds and the last. Both trainers run on the CPU with
   the same command lines and must mark the same rounds. The trainers
   draw their tokens and parameters from their own generators (the port
   cannot reproduce ``jax.random``), so the val values are not compared
   here: the same-token parity of a round and its eval lies in
   ``tests/test_torch_diloco.py``.
2. An async worker's phase makes no host sync inside its H inner steps:
   each step's token draw is timed with CUDA events on the card (the host
   clock on the CPU), read once after the synchronize that closes the
   phase. The draws are the same calls in the same order, so the token
   stream does not change (``tests/test_torch_async.py`` holds the
   engine's state to JAX's).
"""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import async_diloco as TA  # noqa: E402
from repro_torch.core import faults as TF  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402

torch.set_num_threads(2)
BASE = ["--k", "2", "--H", "2", "--batch", "2", "--seq", "32",
        "--eval-batch", "2"]


def _evaled(records):
    return [r["val_loss"] is not None for r in records
            if r["phase"] == "diloco"]


@pytest.mark.parametrize("flags", [
    ["--rounds", "3", "--legacy-loop", "--eval-every", "2"],
    ["--rounds", "4", "--rounds-per-call", "1", "--eval-every", "3"],
])
def test_val_rounds_match_jax_trainer(flags):
    """The two command lines that showed the fault: the port evaluated
    round 1 of the first and rounds 1-2 of the second only after the
    repair."""
    silent = lambda *a, **kw: None
    jrec = jmetrics.RunRecorder(printer=silent)
    want = _evaled(jtrain.run(jtrain.make_parser().parse_args(BASE + flags),
                              recorder=jrec))
    trec = tmetrics.RunRecorder(printer=silent)
    got_records = train.run(train.make_parser().parse_args(
        ["--device", "cpu", *BASE, *flags]), recorder=trec)
    assert _evaled(got_records) == want
    assert all(want)          # both command lines evaluate every round
    assert all(math.isfinite(r["val_loss"]) for r in got_records
               if r["val_loss"] is not None)


def test_eval_rounds_rule():
    """The JAX driver's rule in every mode (``repro/core/diloco.py``
    make_run: g % eval_every == 0 or the chunk's last round)."""
    rule = train.eval_rounds
    assert rule(5, 2, legacy_loop=False, rounds_per_call=0) == [
        False, True, False, True, True]
    assert rule(5, 2, legacy_loop=True, rounds_per_call=0) == [True] * 5
    assert rule(7, 5, legacy_loop=False, rounds_per_call=3) == [
        False, False, True, False, True, True, True]
    assert rule(3, 9, legacy_loop=False, rounds_per_call=1) == [True] * 3


def test_async_phase_makes_no_host_sync(monkeypatch):
    """Inside an async phase the engine never synchronizes the device
    (before the repair it did so twice per inner step around each draw);
    the draws' seconds still reach ``timing``."""
    def loss(p, batch):
        t = batch["tokens"].float().mean() / 7.0
        return torch.sum((p["w"] - t) ** 2), {}

    H = 3
    eng = TA.AsyncEngine(
        loss, lambda g, b, s: torch.randint(0, 7, (b, s), generator=g),
        DiLoCoConfig(k=2, H=H, transport="async"),
        TrainConfig(inner_lr=0.05, warmup_steps=2, total_steps=64,
                    batch_size=2, seq_len=4),
        scenario=TF.Scenario.uniform(2))
    inside, syncs = [False], []
    real_phase, real_sync = eng._phase, TA._sync

    def phase(*a, **kw):
        inside[0] = True
        try:
            return real_phase(*a, **kw)
        finally:
            inside[0] = False

    def sync(device):
        if inside[0]:
            syncs.append(device)
        return real_sync(device)

    monkeypatch.setattr(eng, "_phase", phase)
    monkeypatch.setattr(TA, "_sync", sync)
    state, hist = eng.run(eng.init_state({"w": torch.zeros(4)}), ticks=2)
    assert [r["event"] for r in hist] == ["arrival"] * 4
    assert syncs == []
    assert len(eng.timing) == 4
    assert all(0.0 < e["sample_s"] <= e["phase_s"] for e in eng.timing)
