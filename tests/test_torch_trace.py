"""The port's trace builder (``repro_torch/obs/trace.py``) against the JAX
package's ``obs/trace.py``: on the same inputs both give equal JSON,
event for event (sync with drops and preemption, streaming plan rows,
gossip exchanges, a given overlap dict, async timelines with an engine
history); the validators flag the same mutated bundles; the CLI; and a
property over random fault scenarios. Both packages' faults are pure
numpy functions of their fields, so each side draws its own scenario."""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

SCEN = dict(speeds=(1, 2, 1, 3), latency=(1, 1, 2, 1), drop_prob=0.4,
            max_retries=1, retry_backoff=1, preemptions=((2, 3, 6),),
            seed=7)


def _both(fn_name, jkw, tkw):
    """The JSON of one builder call in each package."""
    j = getattr(jtrace, fn_name)(**jkw).to_json({"note": "x"})
    t = getattr(ttrace, fn_name)(**tkw).to_json({"note": "x"})
    return j, t


def _history(k, rounds):
    return [{"round": r + 1, "inner_loss": 5.0 - 0.25 * r,
             "val_loss": 4.75 - 0.25 * r, "outer_gnorm": 0.125,
             "active": k} for r in range(rounds)]


PLAN = ({"fragment": 0, "send_step": 2, "apply_step": 3, "elems": 8,
         "wire_bytes": 32.0},
        {"fragment": 1, "send_step": 4, "apply_step": 5, "elems": 8,
         "wire_bytes": 36.0})

OVERLAP = {"rows": [
    {"issue_id": 3, "consume_id": 8, "wrapped": True, "deferred": True,
     "steps_between": 1, "dots_between": 32},
    {"issue_id": 1, "consume_id": 2, "wrapped": False, "deferred": True,
     "steps_between": 1, "dots_between": 21},
    {"issue_id": 9, "consume_id": 10, "wrapped": False, "deferred": False,
     "steps_between": 0, "dots_between": 0}],
    "n_collectives": 3, "n_deferred": 2, "min_steps_between": 1,
    "min_dots_between": 21, "tau": 1, "ok": True}


@pytest.mark.parametrize("case", ["sync_faults", "stream_plan",
                                  "gossip", "overlap", "masks_tensor"])
def test_round_trace_equals_jax(case):
    k, rounds, H = 4, 3, 4
    kw = dict(transport="simulated", k=k, rounds=rounds, H=H,
              history=_history(k, rounds))
    jkw, tkw = dict(kw), dict(kw)
    if case in ("sync_faults", "masks_tensor"):
        js, ts = jfaults.Scenario(**SCEN), tfaults.Scenario(**SCEN)
        jd, ja = js.round_masks(k, rounds)
        td, ta = ts.round_masks(k, rounds)
        np.testing.assert_array_equal(jd, td)
        if case == "masks_tensor":          # CPU tensors are host masks
            td, ta = torch.from_numpy(td), torch.from_numpy(ta)
        jkw.update(scenario=js, drops=jd, acts=ja, wire_bytes=1024.0)
        tkw.update(scenario=ts, drops=td, acts=ta, wire_bytes=1024.0)
    elif case == "stream_plan":
        jkw.update(plan=PLAN, wire_bytes=68.0)
        tkw.update(plan=PLAN, wire_bytes=68.0)
    elif case == "gossip":
        g = [{"round": 0, "fragment": 0, "edges": [[0, 1], [2, 3]]},
             {"round": 1, "fragment": 1, "edges": [[0, 2], [1, 3]]}]
        js = jfaults.Scenario(speeds=(1, 2, 1, 1), latency=(0, 1, 0, 0),
                              preemptions=((1, 1, 2),))
        ts = tfaults.Scenario(speeds=(1, 2, 1, 1), latency=(0, 1, 0, 0),
                              preemptions=((1, 1, 2),))
        jd, ja = js.round_masks(k, rounds)
        td, ta = ts.round_masks(k, rounds)
        for d, s, dd, aa in ((jkw, js, jd, ja), (tkw, ts, td, ta)):
            d.update(transport="gossip", scenario=s, drops=dd, acts=aa,
                     gossip_rounds=g)
    else:
        plan = PLAN[:1] + ({**PLAN[1], "apply_step": 5},)
        jkw.update(transport="sharded", plan=plan, overlap=OVERLAP)
        tkw.update(transport="sharded", plan=plan, overlap=OVERLAP)
    j, t = _both("round_trace", jkw, tkw)
    assert t == j
    assert json.dumps(t) == json.dumps(j)
    assert ttrace.validate_trace(t) == [] == jtrace.validate_trace(t)
    assert ttrace.trace_wire_bytes(t) == jtrace.trace_wire_bytes(j)
    if case == "overlap":
        consumes = [e for e in t["traceEvents"]
                    if e["name"] == "consume (measured)"]
        assert len(consumes) == rounds * 2


def test_round_trace_refuses_device_masks():
    """Reading masks off the card would wait for it: only host masks."""
    masks = torch.ones((2, 2), device="meta")
    with pytest.raises(ValueError, match="host masks"):
        ttrace.round_trace(transport="simulated", k=2, rounds=2, H=2,
                           drops=masks)


@pytest.mark.parametrize("ticks", [8, 12])
def test_async_trace_equals_jax(ticks):
    k = 4
    js, ts = jfaults.Scenario(**SCEN), tfaults.Scenario(**SCEN)
    hist = []
    for e in js.timeline(k, ticks):
        if isinstance(e, jfaults.Arrival):
            hist.append({"event": "arrival", "uid": e.uid, "tick": e.tick,
                         "worker": e.worker, "staleness": e.uid % 3,
                         "weight": 0.25, "delta_norm": 0.5,
                         "inner_loss": 4.0, "wire_bytes": 96.0 + e.uid})
        elif isinstance(e, jfaults.Lost):
            hist.append({"event": "lost", "uid": e.uid, "tick": e.tick,
                         "worker": e.worker})
    j, t = _both("async_trace",
                 dict(scenario=js, k=k, ticks=ticks, history=hist,
                      wire_bytes=64.0),
                 dict(scenario=ts, k=k, ticks=ticks, history=hist,
                      wire_bytes=64.0))
    assert t == j
    assert ttrace.span_event_correspondence(t, hist) == []
    assert ttrace.trace_wire_bytes(t) == pytest.approx(
        sum(r["wire_bytes"] for r in hist if r["event"] == "arrival"))


def test_validate_trace_flags_what_jax_flags():
    """The mutated bundles of the JAX package's own validator test."""
    good = ttrace.TraceBuilder().to_json()
    bundles = [good, {"nope": 1},
               {"traceEvents": [{"name": "x", "ph": "Z", "pid": 0,
                                 "tid": 0, "ts": 0.0}]},
               {"traceEvents": [{"name": "x", "ph": "i", "pid": 0,
                                 "tid": 0, "ts": -1.0, "s": "t"}]},
               {"traceEvents": [{"name": "x", "ph": "X", "pid": 0,
                                 "tid": 0, "ts": 0.0, "dur": -5.0}]},
               {"traceEvents": [{"name": 3, "ph": "X", "pid": "0",
                                 "tid": 0, "ts": 0.0, "dur": 1.0,
                                 "args": []}]},
               {"traceEvents": "x"}]
    for b in bundles:
        assert ttrace.validate_trace(b) == jtrace.validate_trace(b)
    assert ttrace.validate_trace(good) == []
    assert all(ttrace.validate_trace(b) for b in bundles[1:])


def test_span_event_correspondence_catches_what_jax_catches():
    ts, js = tfaults.Scenario(**SCEN), jfaults.Scenario(**SCEN)
    ends = [e for e in ts.timeline(4, 8)
            if isinstance(e, (tfaults.Arrival, tfaults.Lost))]
    assert any(isinstance(e, tfaults.Arrival) for e in ends)
    records = [{"event": "arrival" if isinstance(e, tfaults.Arrival)
                else "lost", "uid": e.uid} for e in ends]
    arr = [r for r in records if r["event"] == "arrival"]
    trace = ttrace.async_trace(ts, 4, 8).to_json()
    assert trace == jtrace.async_trace(js, 4, 8).to_json()
    missing = [r for r in records if r is not arr[-1]]
    extra = records + [{"event": "arrival", "uid": 10_000}]
    for recs in (records, extra, missing):
        assert ttrace.span_event_correspondence(trace, recs) == \
            jtrace.span_event_correspondence(trace, recs)
    assert ttrace.span_event_correspondence(trace, records) == []
    assert ttrace.span_event_correspondence(trace, extra)
    assert ttrace.span_event_correspondence(trace, missing)


def test_trace_cli_validates_files(tmp_path, capsys):
    good = tmp_path / "good.json"
    ttrace.async_trace(tfaults.Scenario.uniform(2), 2, 3).write(str(good))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Q"}]}))
    assert ttrace.main([str(good)]) == 0
    assert ttrace.main([str(good), str(bad)]) == 1
    out = capsys.readouterr().out
    assert "[ok]" in out and "[INVALID]" in out
    # the JAX validator's CLI accepts the port's file
    assert jtrace.main([str(good)]) == 0


@st.composite
def _scenarios(draw):
    k = draw(st.integers(2, 5))
    pre = ()
    if draw(st.booleans()):
        leave = draw(st.integers(1, 6))
        rejoin = draw(st.sampled_from([0, leave + 1, leave + 3]))
        pre = ((draw(st.integers(0, k - 1)), leave, rejoin),)
    kw = dict(
        speeds=tuple(draw(st.lists(st.integers(1, 3), min_size=k,
                                   max_size=k))),
        latency=tuple(draw(st.lists(st.integers(0, 2), min_size=k,
                                    max_size=k))),
        latency_jitter=draw(st.sampled_from([0.0, 0.5])),
        drop_prob=draw(st.sampled_from([0.0, 0.3, 0.7])),
        max_retries=draw(st.integers(0, 2)),
        retry_backoff=draw(st.integers(1, 2)),
        preemptions=pre, seed=draw(st.integers(0, 10_000)))
    return k, kw, draw(st.integers(2, 10))


@given(_scenarios())
@settings(max_examples=30, deadline=None)
def test_traces_equal_jax_over_random_scenarios(case):
    """Over random fault scenarios: the async trace and the round trace of
    the scenario's mask projection equal the JAX package's, are valid,
    and every transfer span bijects with the timeline's terminal events."""
    k, kw, ticks = case
    ts, js = tfaults.Scenario(**kw), jfaults.Scenario(**kw)
    t = ttrace.async_trace(ts, k, ticks).to_json()
    assert t == jtrace.async_trace(js, k, ticks).to_json()
    recs = [{"event": "arrival" if isinstance(e, tfaults.Arrival)
             else "lost", "uid": e.uid} for e in ts.timeline(k, ticks)
            if isinstance(e, (tfaults.Arrival, tfaults.Lost))]
    assert ttrace.validate_trace(t) == []
    assert ttrace.span_event_correspondence(t, recs) == []
    rounds = max(1, ticks // max(1, ts.sync_round_ticks(k)))
    td, ta = ts.round_masks(k, rounds)
    jd, ja = js.round_masks(k, rounds)
    r = ttrace.round_trace(transport="simulated", k=k, rounds=rounds, H=4,
                           scenario=ts, drops=td, acts=ta,
                           wire_bytes=64.0).to_json()
    assert r == jtrace.round_trace(transport="simulated", k=k,
                                   rounds=rounds, H=4, scenario=js,
                                   drops=jd, acts=ja,
                                   wire_bytes=64.0).to_json()
    inner = [e for e in r["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "inner phase"]
    assert len(inner) == int(np.asarray(ta).sum())
