"""Streaming rounds on the bfloat16 transport with P=4 fragments against the
JAX package's: τ ∈ {0, 2} × α ∈ {1, 0.5} × error feedback off/on, three
rounds each with drop, active and weight masks, every ``StreamState``
field compared (the harness and its tolerances: ``test_torch_streaming.py``).
One file per transport and P: the tier-1 command runs pytest with
``-n 6 --dist loadfile``, which hands each file whole to one worker, and
the 48 cases of the grid take ~1000 CPU-seconds of JAX compiles.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")
from test_torch_streaming import assert_case_matches, run_case  # noqa: E402


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("tau", [0, 2])
def test_stream_round_matches_jax(tau, alpha, ef):
    want, got, jms, tms, steps = run_case(4, tau, alpha, "bfloat16", ef)
    assert_case_matches(want, got, jms, tms, steps, transport="bfloat16")
    assert ("residual" in got) == ef
    assert ("inflight" in got) == (tau > 0)
