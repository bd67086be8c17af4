"""Tick-domain Chrome-trace export for every transport (the JAX
``obs/trace.py``): the same lanes, names, ``TICK_US`` and event schema,
so that a trace written by either package reads and validates in the
other.

Maps the deterministic tick-domain world the port already computes —
``faults.Scenario.timeline`` events, transfer in-flight windows
(latency + jitter + retries), the streaming fragment schedule's
snapshot→gather→merge offsets — onto Chrome trace-event JSON:

  * one lane (pid/tid) per worker: inner-compute phases and
    worker→server transfers as spans, Arrival / Lost / Leave / Join as
    instants, preemption gaps as spans;
  * one lane per streaming fragment: the in-flight gather window from
    its snapshot offset to its α-merge, carrying the wire bytes the
    transport charges;
  * a rounds lane for barrier-paced transports, one span per outer
    round annotated with the round record (loss, active count).

On the sharded transport the fragment lanes also carry the issue→consume
offsets measured on the run's own deferred gathers
(``pod_collectives.OverlapProbe``), where the JAX trainer reads them from
the lowered HLO. Everything here runs on the host: ``drops`` and
``acts`` are numpy arrays or CPU tensors (a CUDA tensor is refused, so
that drawing a trace never waits for the card).

The produced file loads in Perfetto (https://ui.perfetto.dev) or
chrome://tracing; 1 tick is rendered as 1 ms. ``validate_trace``
checks structural well-formedness, ``span_event_correspondence``
checks the exactly-once contract (every applied delta ↔ exactly one
delivered transfer span); ``python -m repro_torch.obs.trace FILE…`` is
the CLI validator.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..core import faults
from .metrics import to_jsonable

TICK_US = 1000.0            # 1 tick -> 1 ms on the Perfetto timeline

PID_ROUNDS = 0              # barrier-paced round spans
PID_WORKERS = 1             # one tid per worker
PID_FRAGMENTS = 2           # one tid per streaming fragment

_VALID_PH = {"M", "X", "i", "I", "B", "E", "C"}


class TraceBuilder:
    """Accumulates Chrome trace events in tick units (converted to µs
    at append time). Lane naming goes through ``process``/``thread``
    metadata events so Perfetto shows readable groups."""

    def __init__(self):
        self.events: list = []
        self._named: set = set()

    def process(self, pid: int, name: str):
        if ("p", pid) not in self._named:
            self._named.add(("p", pid))
            self.events.append({"name": "process_name", "ph": "M",
                                "pid": pid, "tid": 0,
                                "args": {"name": name}})

    def thread(self, pid: int, tid: int, name: str):
        if ("t", pid, tid) not in self._named:
            self._named.add(("t", pid, tid))
            self.events.append({"name": "thread_name", "ph": "M",
                                "pid": pid, "tid": tid,
                                "args": {"name": name}})

    def span(self, name: str, *, pid: int, tid: int, start, dur,
             args: dict | None = None, cat: str = ""):
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": float(start) * TICK_US,
              "dur": max(0.0, float(dur)) * TICK_US}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, *, pid: int, tid: int, tick,
                args: dict | None = None, cat: str = ""):
        ev = {"name": name, "ph": "i", "pid": pid, "tid": tid,
              "ts": float(tick) * TICK_US, "s": "t"}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def to_json(self, other_data: dict | None = None) -> dict:
        return to_jsonable({"traceEvents": self.events,
                            "displayTimeUnit": "ms",
                            "otherData": other_data or {}})

    def write(self, path: str, other_data: dict | None = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(other_data), f, indent=1)
        return path


def _host(x):
    """(rounds, k) masks as numpy: numpy arrays pass, CPU tensors are
    read, a CUDA tensor is refused (reading it would wait for the card)."""
    if x is None or not torch.is_tensor(x):
        return None if x is None else np.asarray(x)
    if x.device.type != "cpu":
        raise ValueError("round_trace takes host masks (numpy or CPU "
                         f"tensors), got a tensor on {x.device}")
    return x.numpy()


def _worker_lanes(tb: TraceBuilder, k: int):
    tb.process(PID_WORKERS, "workers")
    for w in range(k):
        tb.thread(PID_WORKERS, w, f"worker {w}")


# ---------------------------------------------------------------------------
# barrier-free (async) runs: the event timeline IS the trace
# ---------------------------------------------------------------------------

def async_trace(scenario: faults.Scenario, k: int, ticks: int, *,
                history=(), wire_bytes: float = 0.0) -> TraceBuilder:
    """Trace of a barrier-free run: replays ``scenario.timeline`` onto
    worker lanes. For each terminal event the compute span covers
    [dispatch, finish]; each send attempt departs ``retry_backoff``
    ticks after the previous drop, so the delivered transfer span is
    [finish + attempt·backoff, arrival] with one dropped-send instant
    per failed attempt, and a Lost payload's span runs to its give-up
    tick. ``history`` (engine event records) annotates spans with the
    applied staleness / weight / delta norm; the timeline alone (no
    engine run) still yields a complete, valid trace."""
    tb = TraceBuilder()
    _worker_lanes(tb, k)
    by_uid = {r["uid"]: r for r in history if "uid" in r}
    backoff = max(1, int(scenario.retry_backoff))
    n_attempts = 1 + max(0, int(scenario.max_retries))
    gone_since: dict[int, int] = {}
    events = scenario.timeline(k, ticks)
    for ev in events:
        if isinstance(ev, faults.Arrival):
            tb.span("inner phase", pid=PID_WORKERS, tid=ev.worker,
                    start=ev.dispatch_tick,
                    dur=ev.finish_tick - ev.dispatch_tick, cat="compute",
                    args={"uid": ev.uid, "worker": ev.worker})
            depart = ev.finish_tick + ev.attempt * backoff
            for a in range(ev.attempt):
                tb.instant("dropped send", pid=PID_WORKERS,
                           tid=ev.worker, tick=ev.finish_tick + a * backoff,
                           args={"uid": ev.uid, "attempt": a})
            rec = by_uid.get(ev.uid, {})
            args = {"uid": ev.uid, "worker": ev.worker,
                    "attempt": ev.attempt, "delivered": True,
                    "wire_bytes": float(rec.get("wire_bytes",
                                                wire_bytes))}
            for key in ("staleness", "weight", "delta_norm",
                        "inner_loss", "val_loss", "ppl"):
                if key in rec:
                    args[key] = rec[key]
            tb.span("transfer", pid=PID_WORKERS, tid=ev.worker,
                    start=depart, dur=ev.tick - depart, cat="wire",
                    args=args)
            tb.instant("apply", pid=PID_WORKERS, tid=ev.worker,
                       tick=ev.tick, args={"uid": ev.uid,
                                           "attempt": ev.attempt})
        elif isinstance(ev, faults.Lost):
            if ev.dispatch_tick >= 0:
                tb.span("inner phase", pid=PID_WORKERS, tid=ev.worker,
                        start=ev.dispatch_tick,
                        dur=ev.finish_tick - ev.dispatch_tick,
                        cat="compute",
                        args={"uid": ev.uid, "worker": ev.worker})
                for a in range(n_attempts):
                    tb.instant("dropped send", pid=PID_WORKERS,
                               tid=ev.worker,
                               tick=ev.finish_tick + a * backoff,
                               args={"uid": ev.uid, "attempt": a})
                tb.span("transfer (lost)", pid=PID_WORKERS,
                        tid=ev.worker, start=ev.finish_tick,
                        dur=ev.tick - ev.finish_tick, cat="wire",
                        args={"uid": ev.uid, "worker": ev.worker,
                              "delivered": False,
                              "attempts": n_attempts})
            tb.instant("lost", pid=PID_WORKERS, tid=ev.worker,
                       tick=ev.tick, args={"uid": ev.uid})
        elif isinstance(ev, faults.Leave):
            gone_since[ev.worker] = ev.tick
            tb.instant("leave", pid=PID_WORKERS, tid=ev.worker,
                       tick=ev.tick)
        elif isinstance(ev, faults.Join):
            since = gone_since.pop(ev.worker, ev.tick)
            tb.span("preempted", pid=PID_WORKERS, tid=ev.worker,
                    start=since, dur=ev.tick - since, cat="fault")
            tb.instant("join", pid=PID_WORKERS, tid=ev.worker,
                       tick=ev.tick)
    for w, since in gone_since.items():
        tb.span("preempted", pid=PID_WORKERS, tid=w, start=since,
                dur=ticks - since, cat="fault")
    return tb


# ---------------------------------------------------------------------------
# barrier-paced runs (sync / streaming / sharded / gossip)
# ---------------------------------------------------------------------------

def round_trace(*, transport: str, k: int, rounds: int, H: int,
                scenario: faults.Scenario | None = None, drops=None,
                acts=None, history=(), plan=(), wire_bytes=None,
                gossip_rounds=(), overlap=None) -> TraceBuilder:
    """Trace of a barrier-paced run. Round r spans the tick window
    [r·T, (r+1)·T) with T = ``sync_round_ticks`` (1 under no
    scenario); each active worker's inner compute covers its own speed
    and its outer send pays its link latency; the barrier absorbs the
    rest of the window. Streaming fragment lanes map the staggered
    schedule (``plan`` rows from ``streaming.sync_plan``) into each
    round's compute window — a fragment whose apply crosses the round
    boundary draws its in-flight gather through the barrier, the
    overlap the schedule exists to create. ``gossip_rounds``
    ({"round", "fragment", "edges"} rows) draws the realized pairwise
    exchanges. ``overlap`` (``pod_collectives.OverlapProbe.overlap``,
    the keys of the JAX ``hlo_analysis.stream_overlap``) overlays the
    MEASURED issue→consume separation onto each fragment lane — the
    scheduled gather span plus a "consume (measured)" marker at the
    measured offset. ``drops`` and ``acts``: (rounds, k) numpy arrays or
    CPU tensors."""
    drops, acts = _host(drops), _host(acts)
    scenario = scenario or faults.Scenario.uniform(k)
    speeds = scenario.resolved_speeds(k)
    lat = scenario.resolved_latency(k)
    T = scenario.sync_round_ticks(k)
    smax = max(speeds)
    tb = TraceBuilder()
    tb.process(PID_ROUNDS, "rounds")
    tb.thread(PID_ROUNDS, 0, "outer rounds")
    _worker_lanes(tb, k)
    by_round = {r["round"]: r for r in history if "round" in r}
    for r in range(rounds):
        lo = r * T
        rec = by_round.get(r + 1, {})
        args = {kk: rec[kk] for kk in ("inner_loss", "val_loss",
                                       "outer_gnorm", "active")
                if kk in rec}
        tb.span(f"round {r + 1}", pid=PID_ROUNDS, tid=0, start=lo,
                dur=T, args=args or None)
        for w in range(k):
            if acts is not None and not acts[r][w]:
                continue
            tb.span("inner phase", pid=PID_WORKERS, tid=w, start=lo,
                    dur=speeds[w], cat="compute",
                    args={"round": r + 1, "worker": w})
            finish = lo + speeds[w]
            if drops is not None and not drops[r][w]:
                tb.instant("dropped", pid=PID_WORKERS, tid=w,
                           tick=finish, args={"round": r + 1})
            elif transport != "gossip" and not plan \
                    and wire_bytes is not None:
                tb.span("outer send", pid=PID_WORKERS, tid=w,
                        start=finish, dur=lat[w], cat="wire",
                        args={"round": r + 1, "worker": w,
                              "delivered": True,
                              "wire_bytes": float(wire_bytes)})
    if acts is not None:
        _preempt_spans(tb, acts, k, rounds, T)
    if plan:
        _fragment_lanes(tb, plan, k=k, rounds=rounds, H=H, T=T,
                        smax=smax, overlap=overlap)
    for g in gossip_rounds:
        for i, j in g.get("edges", ()):
            lo = g["round"] * T
            for a, b in ((i, j), (j, i)):
                tb.instant("exchange", pid=PID_WORKERS, tid=a,
                           tick=lo + speeds[a],
                           args={"partner": b,
                                 "fragment": g.get("fragment"),
                                 "round": g["round"] + 1})
    return tb


def _preempt_spans(tb: TraceBuilder, acts, k: int, rounds: int, T: int):
    """Contiguous inactive-round stretches drawn as preemption spans."""
    for w in range(k):
        start = None
        for r in range(rounds + 1):
            gone = r < rounds and not acts[r][w]
            if gone and start is None:
                start = r
            elif not gone and start is not None:
                tb.span("preempted", pid=PID_WORKERS, tid=w,
                        start=start * T, dur=(r - start) * T,
                        cat="fault")
                start = None


def _fragment_lanes(tb: TraceBuilder, plan, *, k: int, rounds: int,
                    H: int, T: int, smax: int, overlap=None):
    tb.process(PID_FRAGMENTS, "fragments")
    for row in plan:
        tb.thread(PID_FRAGMENTS, row["fragment"],
                  f"fragment {row['fragment']}")
    # measured issue→consume rows, matched to schedule rows by issue
    # order: deferred wire collectives are issued in send_step order (the
    # wrapped fragment sends at H, last), so sorting both sides aligns
    # fragment ↔ collective. The arg names are the JAX trace's.
    measured = {}
    if overlap:
        wire = sorted((m for m in overlap.get("rows", ())
                       if m.get("deferred")),
                      key=lambda m: m["issue_id"])
        frags = sorted(plan, key=lambda row: row["send_step"])
        measured = {row["fragment"]: m for row, m in zip(frags, wire)}
    for r in range(rounds):
        lo = r * T
        for row in plan:
            p = row["fragment"]
            send_t = lo + row["send_step"] / H * smax
            a = row["apply_step"]
            apply_t = (lo + a / H * smax if a <= H
                       else lo + T + (a - H) / H * smax)
            tb.instant("snapshot", pid=PID_FRAGMENTS, tid=p,
                       tick=send_t, args={"round": r + 1})
            args = {"round": r + 1, "fragment": p,
                    "delivered": True,
                    "wire_bytes": float(row["wire_bytes"]),
                    "elems": row.get("elems"),
                    "crosses_round": bool(a > H)}
            m = measured.get(p)
            if m is not None:
                args.update(
                    hlo_issue_id=m["issue_id"],
                    hlo_consume_id=m["consume_id"],
                    measured_steps_between=m["steps_between"],
                    measured_dots_between=m["dots_between"],
                    wrapped=bool(m["wrapped"]))
            tb.span("gather (in flight)", pid=PID_FRAGMENTS, tid=p,
                    start=send_t, dur=apply_t - send_t, cat="wire",
                    args=args)
            if m is not None:
                tb.instant(
                    "consume (measured)", pid=PID_FRAGMENTS, tid=p,
                    tick=send_t + m["steps_between"] / H * smax,
                    args={"round": r + 1, "fragment": p,
                          "steps_after_issue": m["steps_between"],
                          "dots_after_issue": m["dots_between"]})
            tb.instant("merge", pid=PID_FRAGMENTS, tid=p, tick=apply_t,
                       args={"round": r + 1, "fragment": p})


# ---------------------------------------------------------------------------
# structural gates
# ---------------------------------------------------------------------------

def validate_trace(trace) -> list:
    """Structural well-formedness of a Chrome trace-event bundle.
    Returns a list of error strings — [] means valid (the shape
    Perfetto's JSON importer accepts)."""
    errors = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["trace must be a dict with a 'traceEvents' list"]
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    for n, e in enumerate(evs):
        where = f"event {n}"
        if not isinstance(e, dict):
            errors.append(f"{where}: not a dict")
            continue
        ph = e.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            errors.append(f"{where}: missing name")
        for key in ("pid", "tid"):
            if not isinstance(e.get(key), int):
                errors.append(f"{where}: missing int {key}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errors.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: bad dur {dur!r}")
        if "args" in e and not isinstance(e["args"], dict):
            errors.append(f"{where}: args must be a dict")
    try:
        json.dumps(trace)
    except (TypeError, ValueError) as exc:
        errors.append(f"not JSON-serializable: {exc}")
    return errors


def transfer_spans(trace) -> list:
    """All wire spans (cat='wire', ph='X') in a trace bundle."""
    return [e for e in trace.get("traceEvents", ())
            if e.get("ph") == "X" and e.get("cat") == "wire"]


def span_event_correspondence(trace, records) -> list:
    """The exactly-once gate: every applied delta ("arrival" record)
    has exactly one delivered transfer span carrying its uid, every
    permanently-lost payload exactly one undelivered span, and no wire
    span exists without its record. Returns error strings ([] = the
    contract holds)."""
    errors = []
    delivered, undelivered = {}, {}
    for e in transfer_spans(trace):
        a = e.get("args", {})
        if "uid" not in a:
            continue
        bucket = delivered if a.get("delivered") else undelivered
        bucket[a["uid"]] = bucket.get(a["uid"], 0) + 1
    want_arr = [r["uid"] for r in records if r.get("event") == "arrival"]
    want_lost = [r["uid"] for r in records if r.get("event") == "lost"]
    for uid in want_arr:
        if delivered.get(uid) != 1:
            errors.append(f"arrival uid {uid}: "
                          f"{delivered.get(uid, 0)} delivered spans "
                          "(want exactly 1)")
    for uid in want_lost:
        if undelivered.get(uid) != 1:
            errors.append(f"lost uid {uid}: "
                          f"{undelivered.get(uid, 0)} lost spans "
                          "(want exactly 1)")
    for uid in set(delivered) - set(want_arr):
        errors.append(f"delivered span uid {uid} has no arrival record")
    for uid in set(undelivered) - set(want_lost):
        errors.append(f"lost span uid {uid} has no lost record")
    return errors


def trace_wire_bytes(trace) -> float:
    """Total bytes annotated on delivered wire spans — the number that
    is held against the recorder's wire accounting."""
    return float(sum(e.get("args", {}).get("wire_bytes", 0.0)
                     for e in transfer_spans(trace)
                     if e.get("args", {}).get("delivered")))


# ---------------------------------------------------------------------------
# CLI validator
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate Chrome trace-event files produced by "
                    "repro_torch.obs (exit 1 on the first invalid "
                    "file).")
    ap.add_argument("paths", nargs="+", help="trace JSON files")
    args = ap.parse_args(argv)
    bad = 0
    for path in args.paths:
        with open(path) as f:
            trace = json.load(f)
        errors = validate_trace(trace)
        n_spans = sum(1 for e in trace.get("traceEvents", ())
                      if isinstance(e, dict) and e.get("ph") == "X")
        if errors:
            bad += 1
            print(f"[INVALID] {path}: {len(errors)} error(s)")
            for e in errors[:10]:
                print("   ", e)
        else:
            print(f"[ok] {path}: "
                  f"{len(trace['traceEvents'])} events, "
                  f"{n_spans} spans, "
                  f"{trace_wire_bytes(trace):.0f} B on the wire")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
