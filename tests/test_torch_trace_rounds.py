"""``--trace`` on the gossip (butterfly) and sharded (``--pods 2``, τ=1)
transports, through the port's trainer against the JAX trainer's file
for the same flags, at smoke width on the CPU (``tests/
test_torch_trace_cli.py`` holds sync, streaming and async).

The sharded trace's issue→consume overlay is measured on the port's own
deferred gathers (``pod_collectives.OverlapProbe``): every deferred wire
is consumed τ inner steps after its issue (``ok``, ``min_steps_between``
≥ τ). The JAX trainer reads the same offsets from its lowered HLO, a
reading its own ``test_hlo_overlap_issue_consume_separation`` shows
wrong on the CPU (it finds 2 and 0 steps where the schedule has τ = 1):
the ``consume (measured)`` instants are therefore compared with the
schedule here, and every other event with the JAX file."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.obs import trace as ttrace  # noqa: E402

from test_torch_trace_cli import geometry, traces  # noqa: E402

SHARDED = ["--transport", "sharded", "--pods", "2", "--stream-fragments",
           "2", "--stream-tau", "1", "--stream-alpha", "0.5",
           "--outer-grad-dtype", "int4", "--error-feedback"]


def test_gossip_trace_equals_jax(tmp_path):
    t, j, rec = traces(tmp_path, ["--transport", "gossip", "--k", "4",
                                  "--stream-fragments", "2",
                                  "--outer-grad-dtype", "bfloat16"])
    assert geometry(t) == geometry(j)
    ex = [e for e in t["traceEvents"] if e["name"] == "exchange"]
    # butterfly on k=4: two edges a round, an instant for each end
    assert len(ex) == 2 * 2 * 2
    assert all(e["args"]["partner"] != e["tid"] for e in ex)


def test_sharded_trace_equals_jax_and_overlap_is_measured(tmp_path):
    full, j, rec = traces(tmp_path, SHARDED)
    skip = ("consume (measured)",)
    assert geometry(full, skip) == geometry(j, skip)
    assert ttrace.trace_wire_bytes(full) == pytest.approx(
        rec.wire_bytes_total)
    tau = 1
    overlap = full["otherData"]["overlap"]
    assert overlap["ok"] and overlap["tau"] == tau
    assert overlap["min_steps_between"] >= tau
    assert overlap["n_deferred"] == 2 and overlap["dots_between_counts"]
    # the port's measured offsets, on the fragment lanes
    gathers = [e for e in full["traceEvents"]
               if e["name"] == "gather (in flight)"]
    consumes = [e for e in full["traceEvents"]
                if e["name"] == "consume (measured)"]
    assert len(consumes) == len(gathers) == 2 * 2
    for g in gathers:
        a = g["args"]
        assert a["measured_steps_between"] == tau
        assert a["measured_dots_between"] > 0
        assert a["hlo_consume_id"] > a["hlo_issue_id"]
    # the wrapped fragment (sent at H, merged in the next round) is the
    # one whose gather crosses the round
    assert {g["args"]["wrapped"] for g in gathers} == {True, False}
    for g in gathers:
        assert g["args"]["wrapped"] == g["args"]["crosses_round"]
    # each consume sits tau steps after its snapshot: with H = 2 and one
    # tick a round, half a tick
    snaps = {(e["args"]["round"], e["tid"]): e["ts"]
             for e in full["traceEvents"] if e["name"] == "snapshot"}
    for c in consumes:
        assert c["ts"] - snaps[(c["args"]["round"], c["tid"])] == \
            pytest.approx(tau / 2 * ttrace.TICK_US)
    notes = [n["note"] for n in rec.manifest.get("notes", ())]
    assert any(n.startswith("trace: ") for n in notes)
