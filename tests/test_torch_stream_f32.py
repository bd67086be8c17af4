"""Streaming rounds on the float32 transport against the JAX package's:
P ∈ {2, 4} × τ ∈ {0, 2} × α ∈ {1, 0.5} × error feedback off/on (which
keeps no residual on float32), three rounds each with drop, active and
weight masks, every ``StreamState`` field compared (the harness and its
tolerances: ``test_torch_streaming.py``). One file per transport (and P):
the tier-1 command runs pytest with ``-n 6 --dist loadfile``, which hands
each file whole to one worker, and the 48 cases of the grid take ~1000
CPU-seconds of JAX compiles.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")
from test_torch_streaming import assert_case_matches, run_case  # noqa: E402


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("tau", [0, 2])
@pytest.mark.parametrize("P", [2, 4])
def test_stream_round_matches_jax(P, tau, alpha, ef):
    want, got, jms, tms, steps = run_case(P, tau, alpha, "float32", ef)
    assert_case_matches(want, got, jms, tms, steps, transport="float32")
    assert "residual" not in got and "inflight" not in got
