"""Compute-pool schedules (Fig 7) and communication-drop masks (Fig 8).

The adaptive-compute study varies how many replicas are active per outer
round; the async study drops each replica's outer gradient independently
with probability p. Both are expressed as per-round (k,) float masks fed
to ``core.diloco.outer_step`` / ``inner_phase``.
"""
from __future__ import annotations

import numpy as np


def compute_schedule(kind: str, k: int, n_rounds: int) -> np.ndarray:
    """(n_rounds,) int — active replica count per round.

    Kinds (paper Fig 7): constant_local (1), constant_distributed (k),
    doubling (k/2 then k), halving (k then k/2), ramp_up (1 -> k),
    ramp_down (k -> 1).
    """
    t = np.arange(n_rounds)
    half = n_rounds // 2
    if kind == "constant_local":
        n = np.ones(n_rounds)
    elif kind == "constant_distributed":
        n = np.full(n_rounds, k)
    elif kind == "doubling":
        n = np.where(t < half, k // 2, k)
    elif kind == "halving":
        n = np.where(t < half, k, k // 2)
    elif kind == "ramp_up":
        n = np.clip(np.round(1 + (k - 1) * t / max(n_rounds - 1, 1)), 1, k)
    elif kind == "ramp_down":
        n = np.clip(np.round(k - (k - 1) * t / max(n_rounds - 1, 1)), 1, k)
    else:
        raise ValueError(kind)
    return n.astype(np.int32)


def active_mask(n_active: int, k: int) -> np.ndarray:
    """(k,) float mask with the first ``n_active`` replicas active."""
    m = np.zeros((k,), np.float32)
    m[:n_active] = 1.0
    return m


def active_masks(schedule: np.ndarray, k: int) -> np.ndarray:
    """(n_rounds, k) float — per-round active masks for a compute
    schedule, in the stacked layout the scanned driver consumes."""
    return np.stack([active_mask(int(n), k) for n in schedule])


def drop_masks(rng: np.random.Generator, drop_prob: float, k: int,
               n_rounds: int) -> np.ndarray:
    """(n_rounds, k) float — 1 = communicated, 0 = dropped (Fig 8)."""
    if drop_prob <= 0:
        return np.ones((n_rounds, k), np.float32)
    return (rng.random((n_rounds, k)) >= drop_prob).astype(np.float32)


def total_compute(schedule: np.ndarray, H: int) -> int:
    """Total inner steps summed over replicas (the x-axis of Fig 7)."""
    return int(schedule.sum()) * H
