"""The port's async engine against the JAX package's under scenario B:
speeds (1, 2), send drops at 0.3 with one retry, worker 1 preempted from
tick 3 to tick 5, seed 0, 8 ticks. Its timeline holds a Lost phase (the
worker keeps its params under the same dispatch version), a Leave (the
snapshots pruned to the live versions), a Join (fresh moments, a fresh
residual) and an arrival that got through on its retry. Every
``state_to_tree`` field and event record is compared, under float32,
bf16 and int4 (with and without error feedback) transports and the mixed
policy with int4 (the harness and its tolerances:
``test_torch_async.py``). A file of its own: the tier-1 command runs
pytest with ``-n 6 --dist loadfile``, which hands each file whole to one
worker.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")
from repro.core import faults as JF  # noqa: E402
from test_torch_async import (CASES, K, SCENARIOS,  # noqa: E402
                              assert_case_matches, run_case)


def test_scenario_b_timeline():
    """The events scenario B scripts, in the JAX timeline."""
    fields, ticks = SCENARIOS["B"]
    kinds = [type(e).__name__ for e in JF.Scenario(**fields).timeline(
        K, ticks)]
    assert kinds[:6] == ["Arrival", "Arrival", "Leave", "Lost", "Join",
                         "Arrival"]
    assert kinds.count("Lost") >= 1 and kinds.count("Join") == 1


@pytest.mark.parametrize("dtype,ef,policy", CASES)
def test_async_scenario_b_matches_jax(dtype, ef, policy):
    want, got, jhist, thist, steps = run_case("B", dtype, ef, policy)
    assert_case_matches(want, got, jhist, thist, steps, transport=dtype,
                        mixed=policy is not None)
    events = [r["event"] for r in thist]
    assert {"arrival", "lost", "leave", "join"} <= set(events)
    assert any(r.get("attempt", 0) == 1 for r in thist)
