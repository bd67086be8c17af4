"""The port's copy of the fault-scenario harness (``core/faults.py``)
against the JAX package's: for the same fields both give the same
``timeline`` (every event, in order), ``round_masks``,
``sync_round_ticks``, ``nan_masks``, ``crash_round`` and
``staleness_weight``, and refuse the same invalid fields with the same
messages. Seeds 0-19 over a grid of speeds, link latency and jitter,
drops with retries and backoff, and preemptions with and without rejoin.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro.core import faults as JF
from repro_torch.core import faults as TF

K = 3
GRID = [
    dict(speeds=(1, 2, 4)),
    dict(speeds=(1, 1, 3), latency=(0, 1, 2), latency_jitter=0.5),
    dict(drop_prob=0.3, max_retries=2, retry_backoff=2),
    dict(speeds=(2, 1, 1), drop_prob=0.5, max_retries=0),
    dict(preemptions=((1, 3, 7),), drop_prob=0.2, max_retries=1),
    dict(speeds=(1, 2, 2), preemptions=((0, 2, 0), (2, 1, 4), (2, 6, 9)),
         latency=(1, 1, 1), latency_jitter=0.3),
    dict(crash_tick=5, nan_bombs=((0, 2), (2, 9))),
]


def _events(tl):
    return [(type(e).__name__, tuple(e)) for e in tl]


@pytest.mark.parametrize("case", range(len(GRID)))
def test_scenarios_equal_jax(case):
    for seed in range(20):
        fields = dict(GRID[case], seed=seed)
        js, ts = JF.Scenario(**fields), TF.Scenario(**fields)
        for ticks in (1, 6, 13):
            assert _events(ts.timeline(K, ticks)) == _events(
                js.timeline(K, ticks)), (fields, ticks)
        for rounds in (1, 5):
            for a, b in zip(ts.round_masks(K, rounds),
                            js.round_masks(K, rounds)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ts.nan_masks(K, rounds),
                                          js.nan_masks(K, rounds))
        assert ts.sync_round_ticks(K) == js.sync_round_ticks(K)
        assert ts.crash_round(K) == js.crash_round(K)


def test_named_constructors_equal_jax():
    for name, args in (("uniform", (4,)), ("stragglers", (4, (2, 3))),
                       ("wan", (3, 2, 0.25)), ("preempt", (3, 1, 2, 5)),
                       ("drop", (3, 0.4, 2, 3))):
        t, j = getattr(TF.Scenario, name)(*args), getattr(
            JF.Scenario, name)(*args)
        assert t.__dict__ == j.__dict__
        assert _events(t.timeline(len(t.speeds), 9)) == _events(
            j.timeline(len(j.speeds), 9))


@pytest.mark.parametrize("lam,k", itertools.product([0.0, 0.5, 0.7, 1.0],
                                                    [1, 2, 8]))
def test_staleness_weight_equal_jax(lam, k):
    for tau in range(6):
        assert TF.staleness_weight(tau, lam, k) == JF.staleness_weight(
            tau, lam, k)


@pytest.mark.parametrize("fields,view", [
    (dict(drop_prob=1.5), None), (dict(latency_jitter=-1.0), None),
    (dict(max_retries=-1), None), (dict(retry_backoff=0), None),
    (dict(preemptions=((0, 1),)), None), (dict(preemptions=((0, -1, 2),)),
                                          None),
    (dict(nan_bombs=((0,),)), None), (dict(nan_bombs=((0, -2),)), None),
    (dict(speeds=(1, 2)), "timeline"), (dict(speeds=(1, 0, 1)), "timeline"),
    (dict(latency=(1,)), "timeline"), (dict(latency=(0, -1, 0)),
                                       "timeline"),
    (dict(preemptions=((5, 1, 2),)), "timeline"),
    (dict(preemptions=((0, 4, 2),)), "timeline"),
    (dict(preemptions=((0, 1, 5), (0, 3, 6))), "round_masks"),
    (dict(preemptions=((0, 1, 0), (0, 3, 6))), "round_masks"),
    (dict(nan_bombs=((4, 1),)), "nan_masks"),
    (dict(staleness=1.5), "weight"),
])
def test_validation_errors_equal_jax(fields, view):
    """The same invalid fields raise the same errors with the same
    messages, at construction or in the view that depends on k."""
    def err(mod):
        try:
            if view == "weight":
                mod.staleness_weight(1, fields["staleness"], K)
                return None
            s = mod.Scenario(**fields)
            if view == "timeline":
                s.timeline(K, 8)
            elif view == "round_masks":
                s.round_masks(K, 4)
            elif view == "nan_masks":
                s.nan_masks(K, 4)
        except (ValueError, TypeError) as e:
            return type(e), str(e)
        return None

    got, want = err(TF), err(JF)
    assert want is not None, fields
    assert got == want
