"""Host-side anomaly guard: rolling loss statistics, spike verdicts and
the rollback budget (the JAX ``resilience/guard.py``).

Two tiers of defense:

- **On the device** (``core.diloco.outer_step`` under
  ``dcfg.guard_outer``): a replica whose outer delta holds a NaN or an
  Inf is left out of the reduce; optional norm-outlier clipping. Exact
  identities on clean rounds.
- **On the host** (this module): the trainer hands each finished chunk's
  per-round losses to ``AnomalyGuard.observe_chunk``; a non-finite loss,
  or one beyond ``spike`` rolling standard deviations, is an anomaly. The
  trainer then restores the last good snapshot
  (``CheckpointManager.latest_good``) and replays from it with the
  device guard armed, at most ``max_rollbacks`` times a run.

The guard reads only the metrics the chunk boundary already copied to
the host (``RunRecorder.ingest_chunk``): it adds no device sync.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class GuardConfig:
    window: int = 8         # rolling-statistics window (rounds)
    spike: float = 4.0      # trip at mean + spike * std
    min_history: int = 4    # verdicts need this much history first
    min_std: float = 1e-3   # std floor so a flat window can't hair-trigger
    max_rollbacks: int = 2  # escalation budget for the whole run

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.spike <= 0:
            raise ValueError(f"spike must be > 0, got {self.spike}")
        if self.min_history < 1:
            raise ValueError(
                f"min_history must be >= 1, got {self.min_history}")
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}")


class AnomalyGuard:
    """Rolling loss monitor. ``observe`` is called once per finished
    round; an anomalous loss is not folded into the window, so one spike
    cannot move the baseline it is judged against."""

    def __init__(self, cfg: GuardConfig = GuardConfig(), *,
                 recorder=None):
        self.cfg = cfg
        self.recorder = recorder
        self._window: deque = deque(maxlen=cfg.window)
        self.rollbacks_used = 0
        self.skipped_rounds: set = set()
        self.verdicts: list = []

    def stats(self) -> tuple:
        """(mean, std) of the rolling window (nan, nan when empty)."""
        if not self._window:
            return float("nan"), float("nan")
        n = len(self._window)
        mean = sum(self._window) / n
        var = sum((x - mean) ** 2 for x in self._window) / n
        return mean, math.sqrt(var)

    def observe(self, round_idx: int, loss: float) -> dict:
        """Judge one round's loss. Returns ``{"ok", "reason", "round",
        "loss", "mean", "std"}``."""
        loss = float(loss)
        mean, std = self.stats()
        verdict = {"ok": True, "reason": None, "round": int(round_idx),
                   "loss": loss, "mean": mean, "std": std}
        if not math.isfinite(loss):
            verdict.update(ok=False, reason="non_finite")
        elif (len(self._window) >= self.cfg.min_history
              and loss > mean + self.cfg.spike * max(std,
                                                     self.cfg.min_std)):
            verdict.update(ok=False, reason="spike")
        if verdict["ok"]:
            self._window.append(loss)
        else:
            self._emit("anomaly", verdict)
        self.verdicts.append(verdict)
        return verdict

    def observe_chunk(self, first_round: int, losses) -> list:
        """Judge a chunk's losses (in round order). Returns the verdicts
        of the anomalous rounds (empty: the chunk is clean)."""
        verdicts = [self.observe(first_round + i, x)
                    for i, x in enumerate(losses)]
        return [v for v in verdicts if not v["ok"]]

    def can_rollback(self) -> bool:
        return self.rollbacks_used < self.cfg.max_rollbacks

    def rolled_back(self, *, to_round: int, skip_round: int) -> None:
        """Record one rollback: the run was restored to the snapshot at
        ``to_round`` and replays ``skip_round`` guarded."""
        self.rollbacks_used += 1
        self.skipped_rounds.add(int(skip_round))
        self._emit("rollback", {"round": int(skip_round),
                                "restored_to": int(to_round),
                                "rollbacks_used": self.rollbacks_used})

    def _emit(self, action: str, fields: dict) -> None:
        if self.recorder is None:
            return
        f = {k: v for k, v in fields.items() if k != "round"}
        self.recorder.guard_event(action=action,
                                  round=fields.get("round", -1), **f)
