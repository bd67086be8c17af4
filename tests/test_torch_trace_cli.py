"""``--trace`` through the port's trainer against the JAX trainer's file
for the same flags, at smoke width on the CPU: sync, streaming int4 and
async with a fault scenario here; gossip and the sharded transport in
``tests/test_torch_trace_rounds.py``. Each file passes both packages'
``validate_trace``; its events' phases, lanes, names, ``ts``, ``dur``,
categories and ``wire_bytes`` equal the JAX file's (losses are not
compared: the two trainers draw other tokens); its wire bytes are the
recorder's accounting."""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

torch.set_num_threads(2)
BASE = ["--k", "2", "--H", "2", "--rounds", "2", "--batch", "2", "--seq",
        "16", "--eval-batch", "2"]


def geometry(trace, skip=()) -> list:
    """What the two trainers' traces share: each event's phase, lane,
    name, times, category and wire bytes, in order (events named in
    ``skip`` left out)."""
    return [(e["ph"], e["pid"], e["tid"], e["name"], e.get("ts"),
             e.get("dur"), e.get("cat"),
             e.get("args", {}).get("wire_bytes")) for e in
            trace["traceEvents"] if e["name"] not in skip]


def traces(tmp_path, flags):
    """(port trace, JAX trace, port recorder) of one run of each trainer
    with ``flags`` and ``--trace``, both traces validated by both
    packages."""
    out = {}
    recs = {}
    for name, mod, rec in (
            ("torch", train, tmetrics.RunRecorder(
                printer=lambda *a, **k: None)),
            ("jax", jtrain, jmetrics.RunRecorder(
                printer=lambda *a, **k: None))):
        path = tmp_path / f"{name}.json"
        argv = BASE + flags + ["--trace", str(path)]
        if name == "torch":
            argv = ["--device", "cpu"] + argv
        mod.run(mod.make_parser().parse_args(argv), recorder=rec)
        t = json.loads(path.read_text())
        assert ttrace.validate_trace(t) == [], name
        assert jtrace.validate_trace(t) == [], name
        out[name] = t
        recs[name] = rec
    return out["torch"], out["jax"], recs["torch"]


def test_sync_trace_equals_jax(tmp_path):
    flags = ["--drop-prob", "0.5", "--speeds", "1,2", "--preempt", "1:2:4"]
    t, j, rec = traces(tmp_path, flags)
    assert geometry(t) == geometry(j)
    names = {e["name"] for e in t["traceEvents"]}
    assert {"outer send", "dropped", "preempted"} <= names
    # one send span per delivered, active replica-round, carrying the
    # per-replica bytes each round record holds
    drops, acts = train.scenario_of(train.make_parser().parse_args(
        BASE + flags)).round_masks(2, 2)
    sends = int((drops * acts).sum())
    per_round = {r["wire_bytes"] for r in rec.round_records()}
    assert len(per_round) == 1
    assert ttrace.trace_wire_bytes(t) == pytest.approx(
        per_round.pop() * sends)


def test_streaming_int4_trace_equals_jax(tmp_path):
    t, j, rec = traces(tmp_path, ["--stream-fragments", "2",
                                  "--stream-tau", "1", "--stream-alpha",
                                  "0.5", "--outer-grad-dtype", "int4",
                                  "--error-feedback"])
    assert geometry(t) == geometry(j)
    gathers = [e for e in t["traceEvents"]
               if e["name"] == "gather (in flight)"]
    assert len(gathers) == 2 * 2
    # the fragments' spans carry each round's bytes once
    assert ttrace.trace_wire_bytes(t) == pytest.approx(
        rec.wire_bytes_total)


def test_async_fault_trace_equals_jax(tmp_path):
    t, j, rec = traces(tmp_path, ["--transport", "async", "--speeds", "1,2",
                                  "--drop-prob", "0.3", "--max-retries",
                                  "1", "--preempt", "1:3:5", "--ticks",
                                  "8", "--outer-grad-dtype", "int4",
                                  "--error-feedback"])
    assert geometry(t) == geometry(j)
    events = rec.event_records()
    assert ttrace.span_event_correspondence(t, events) == []
    assert ttrace.trace_wire_bytes(t) == pytest.approx(
        rec.wire_bytes_total)
    assert {"transfer (lost)", "preempted", "dropped send"} <= \
        {e["name"] for e in t["traceEvents"]}
