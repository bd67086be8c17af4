"""Fault-injection harness: scripted failure scenarios, a copy of the
JAX package's ``core/faults.py`` (pure numpy, so the port keeps its own
copy and imports nothing of ``repro``). A ``Scenario`` is the same
function of its fields in both packages: the same timelines, masks and
validation errors (``tests/test_torch_faults.py`` holds them equal).

The paper's robustness results (Fig 7/8) and its §5 asynchronous
future work are all statements about *failure modes*: stragglers,
dropped outer gradients, preemptible capacity leaving and joining
mid-run, slow WAN links. This module turns those modes into one
reusable, deterministic ``Scenario`` object that every transport tier
consumes through the view that fits its execution model:

  * round-driven paths (the simulated transport, with or without
    streaming) consume ``round_masks`` — per-round (R, k) drop and
    active masks — plus ``sync_round_ticks`` for the wallclock bill a
    barrier pays per round (the slowest worker plus the slowest link);
  * the barrier-free async engine (``core/async_diloco.py``) consumes
    ``timeline`` — the full ordered event stream (phase completions
    with per-link latency, send drops with retry/backoff, preemption
    leave/join) that drives its no-barrier apply loop.

Determinism is the point: a Scenario is a pure function of its fields
(the rng is seeded per scenario), so a run replays the *same* timeline.
The crash and NaN-bomb fields are the JAX ones: the trainer's
``--crash-at-round``/``--crash-at-tick`` and ``--nan-bomb`` set them
(``launch/train.scenario_of``).

Time is measured in abstract wall-clock *ticks*: 1 tick = the fastest
worker's phase (H inner steps).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np


class Arrival(NamedTuple):
    """A worker's outer gradient reaching the parameter server.

    ``uid`` identifies the underlying phase completion: retries of a
    dropped send share the uid of the payload they resend, and at most
    one Arrival per uid ever appears in a timeline — the exactly-once
    contract the apply-loop property tests check.
    """
    tick: int          # arrival (application) time at the server
    worker: int
    uid: int           # unique phase-completion id
    dispatch_tick: int  # when the phase's params were dispatched
    finish_tick: int   # when the phase's compute finished
    attempt: int       # 0 = first send, n = n-th retry that got through


class Leave(NamedTuple):
    """Preemption: the worker disappears at ``tick`` (any phase still
    in flight is lost with it)."""
    tick: int
    worker: int


class Join(NamedTuple):
    """(Re-)admission: the worker re-dispatches from the global copy
    current at ``tick`` and starts a fresh phase."""
    tick: int
    worker: int


class Lost(NamedTuple):
    """A phase whose send exhausted every retry: the delta is gone for
    good (Fig 8 drop semantics — the worker keeps its own params and
    moves on). Recorded so accounting can prove no silent loss, and so
    a trace can draw the doomed phase's compute + retry window."""
    tick: int          # when the last retry failed
    worker: int
    uid: int
    dispatch_tick: int = -1  # when the phase's params were dispatched
    finish_tick: int = -1    # when its compute finished (first send)


class Crash(NamedTuple):
    """The PROCESS dies at ``tick`` — not a worker fault but a
    crash-grade one: whatever is not durably checkpointed is gone.
    Sorted after every other event at its tick (the crash takes the
    tick's work down with it, having observed it), consumes no rng
    draws and no uid, so a timeline with a Crash is the crash-free
    timeline with one event spliced in: a run resumed from a snapshot
    taken before the crash replays the identical suffix."""
    tick: int


@dataclass(frozen=True)
class Scenario:
    """One scripted failure scenario, deterministic given its fields.

    speeds          per-worker phase duration in ticks (1 = fastest);
                    () = all 1s. len must equal k when non-empty.
    latency         per-worker one-way link latency in ticks added to
                    every send (simulated WAN distance); () = all 0.
    latency_jitter  lognormal multiplicative jitter sigma applied to
                    each send's latency draw (0 = deterministic links).
    drop_prob       probability each send attempt is dropped.
    max_retries     resends after a dropped attempt; a payload whose
                    every attempt drops is permanently Lost.
    retry_backoff   ticks between a dropped attempt and its resend.
    preemptions     ((worker, leave_tick, rejoin_tick), ...) — the
                    worker vanishes at leave_tick and re-dispatches
                    from the global copy at rejoin_tick. rejoin_tick
                    <= 0 means it never returns (elastic shrink).
    seed            rng seed for drops and jitter.
    crash_tick      < 0 disables; >= 0 splices a ``Crash`` event into
                    the timeline at that tick (the launcher SIGKILLs
                    itself — the resilience benchmark's kill switch).
    nan_bombs       ((worker, tick), ...) — worker's outer gradient is
                    poisoned to NaN for the phase covering that tick
                    (round transports: round tick // sync_round_ticks
                    via ``nan_masks``). A hardware-corruption stand-in
                    the anomaly guard must reject.
    """
    speeds: tuple = ()
    latency: tuple = ()
    latency_jitter: float = 0.0
    drop_prob: float = 0.0
    max_retries: int = 0
    retry_backoff: int = 1
    preemptions: tuple = ()
    seed: int = 0
    crash_tick: int = -1
    nan_bombs: tuple = ()

    def __post_init__(self):
        """k-independent input validation — loud errors instead of
        silent mis-simulation (k-dependent checks — worker ranges —
        live in the resolved_* / _preempt_of / nan_masks views)."""
        if not 0.0 <= float(self.drop_prob) <= 1.0:
            raise ValueError(
                f"drop_prob must be in [0, 1], got {self.drop_prob}")
        if float(self.latency_jitter) < 0:
            raise ValueError(f"latency_jitter must be >= 0, got "
                             f"{self.latency_jitter}")
        if int(self.max_retries) < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if int(self.retry_backoff) < 1:
            raise ValueError(f"retry_backoff must be >= 1 tick, got "
                             f"{self.retry_backoff}")
        for pre in self.preemptions:
            if len(pre) != 3:
                raise ValueError(
                    f"preemptions entries are (worker, leave, rejoin) "
                    f"triples, got {pre!r}")
            w, leave, rejoin = (int(x) for x in pre)
            if leave < 0:
                raise ValueError(
                    f"worker {w} leave tick must be >= 0, got {leave}")
            # rejoin <= 0 is the "never returns" sentinel, so only its
            # ordering vs leave is checked (in _preempt_of, per k)
        for bomb in self.nan_bombs:
            if len(bomb) != 2:
                raise ValueError(
                    f"nan_bombs entries are (worker, tick) pairs, "
                    f"got {bomb!r}")
            w, t = (int(x) for x in bomb)
            if t < 0:
                raise ValueError(
                    f"nan bomb for worker {w} has negative tick {t}")

    # ---- named constructors for the canonical scenarios ----

    @staticmethod
    def uniform(k: int, **kw) -> "Scenario":
        return Scenario(speeds=(1,) * k, **kw)

    @staticmethod
    def stragglers(k: int, slow: tuple = (2, 4), **kw) -> "Scenario":
        """Heterogeneous pod speeds: the last ``len(slow)`` workers run
        slow[i]× slower than the rest (the beyond_async setting)."""
        speeds = [1] * k
        for i, s in enumerate(slow):
            speeds[k - len(slow) + i] = int(s)
        return Scenario(speeds=tuple(speeds), **kw)

    @staticmethod
    def wan(k: int, base_latency: int = 1, jitter: float = 0.5,
            **kw) -> "Scenario":
        """Per-link simulated WAN latency with lognormal jitter."""
        return Scenario(speeds=(1,) * k,
                        latency=(int(base_latency),) * k,
                        latency_jitter=float(jitter), **kw)

    @staticmethod
    def preempt(k: int, worker: int, leave: int, rejoin: int,
                **kw) -> "Scenario":
        """One worker preempted at ``leave``, back at ``rejoin``."""
        return Scenario(speeds=(1,) * k,
                        preemptions=((int(worker), int(leave),
                                      int(rejoin)),), **kw)

    @staticmethod
    def drop(k: int, prob: float, max_retries: int = 0,
             retry_backoff: int = 1, **kw) -> "Scenario":
        """Outer-gradient drop with optional retry/backoff."""
        return Scenario(speeds=(1,) * k, drop_prob=float(prob),
                        max_retries=int(max_retries),
                        retry_backoff=int(retry_backoff), **kw)

    # ---- derived views ----

    def resolved_speeds(self, k: int) -> tuple:
        s = tuple(int(x) for x in self.speeds) or (1,) * k
        if len(s) != k:
            raise ValueError(f"speeds has {len(s)} entries for k={k}")
        if any(x < 1 for x in s):
            raise ValueError(f"speeds must be >= 1 ticks, got {s}")
        return s

    def resolved_latency(self, k: int) -> tuple:
        l = tuple(int(x) for x in self.latency) or (0,) * k
        if len(l) != k:
            raise ValueError(f"latency has {len(l)} entries for k={k}")
        if any(x < 0 for x in l):
            raise ValueError(f"latency must be >= 0 ticks, got {l}")
        return l

    def _preempt_of(self, k: int) -> dict:
        """worker -> sorted ((leave, rejoin), ...); validates ticks."""
        out: dict[int, list] = {}
        for w, leave, rejoin in self.preemptions:
            w, leave, rejoin = int(w), int(leave), int(rejoin)
            if not 0 <= w < k:
                raise ValueError(f"preemption worker {w} out of range "
                                 f"for k={k}")
            if 0 < rejoin <= leave:
                raise ValueError(
                    f"worker {w} rejoin tick {rejoin} must be after "
                    f"its leave tick {leave}")
            out.setdefault(w, []).append((leave, rejoin))
        for w, spans in out.items():
            spans.sort()
            for (l1, r1), (l2, _) in zip(spans, spans[1:]):
                if r1 <= 0 or l2 < r1:
                    raise ValueError(
                        f"worker {w} preemption spans overlap: "
                        f"{spans}")
        return out

    def sync_round_ticks(self, k: int) -> int:
        """Wall-clock ticks one BARRIER outer round costs: every worker
        waits for the slowest phase plus the slowest (base) link —
        the bill the barrier-free transports avoid."""
        return (max(self.resolved_speeds(k))
                + max(self.resolved_latency(k)))

    def _bombs_of(self, k: int) -> tuple:
        """Validated ((worker, tick), ...); rejects unknown workers."""
        out = []
        for w, t in self.nan_bombs:
            w, t = int(w), int(t)
            if not 0 <= w < k:
                raise ValueError(
                    f"nan bomb worker {w} out of range for k={k}")
            out.append((w, t))
        return tuple(out)

    def crash_round(self, k: int) -> int:
        """The barrier-paced round a ``crash_tick`` falls in (< 0 when
        no crash is scripted): round r spans ticks [r*T, (r+1)*T)."""
        if self.crash_tick < 0:
            return -1
        return int(self.crash_tick) // self.sync_round_ticks(k)

    def nan_masks(self, k: int, rounds: int):
        """(rounds, k) float mask, 1 where a scripted NaN bomb poisons
        the worker's outer gradient that round (tick -> round via the
        barrier pacing, like ``round_masks``)."""
        T = self.sync_round_ticks(k)
        bombs = np.zeros((rounds, k), np.float32)
        for w, t in self._bombs_of(k):
            r = t // T
            if r < rounds:
                bombs[r, w] = 1.0
        return bombs

    def round_masks(self, k: int, rounds: int):
        """(drops, actives) — two (rounds, k) float arrays in the
        stacked layout ``diloco.make_run`` consumes, projecting this
        scenario onto a barrier-paced run: round r spans ticks
        [r*T, (r+1)*T) with T = ``sync_round_ticks``. A send attempt
        that drops (after exhausting its retries within the barrier)
        zeroes the drop mask; a worker preempted anywhere in the
        round's span is inactive for it."""
        T = self.sync_round_ticks(k)
        rng = np.random.default_rng(self.seed)
        drops = np.ones((rounds, k), np.float32)
        if self.drop_prob > 0:
            # a barrier gives every payload max_retries+1 attempts
            attempts = 1 + max(0, int(self.max_retries))
            p_lost = float(self.drop_prob) ** attempts
            drops = (rng.random((rounds, k)) >= p_lost
                     ).astype(np.float32)
        actives = np.ones((rounds, k), np.float32)
        for w, spans in self._preempt_of(k).items():
            for leave, rejoin in spans:
                end = rejoin if rejoin > 0 else rounds * T
                for r in range(rounds):
                    lo, hi = r * T, (r + 1) * T
                    if lo < end and hi > leave:
                        actives[r, w] = 0.0
        return drops, actives

    def _resolve_send(self, rng, base_lat: int, finish: int):
        """Resolve one payload's send attempts. Returns
        (arrival_tick, None, attempt) when some attempt gets through
        or (None, give_up_tick, None) when every attempt drops. Draw
        order is fixed (jitter then drop, per attempt) so the stream
        is deterministic; a fault-free link consumes zero draws."""
        send = finish
        for attempt in range(1 + max(0, int(self.max_retries))):
            delay = base_lat
            if self.latency_jitter > 0 and base_lat > 0:
                delay = int(round(base_lat * float(
                    rng.lognormal(0.0, self.latency_jitter))))
            dropped = (self.drop_prob > 0
                       and rng.random() < self.drop_prob)
            if not dropped:
                return send + delay, None, attempt
            send += max(1, int(self.retry_backoff))
        return None, send, None

    @staticmethod
    def _emit_preemption(events: list, worker: int, span, ticks: int):
        """Emit Leave (and Join when the worker comes back inside the
        horizon). Returns the rejoin tick, or None if the worker is
        gone for the rest of the run."""
        leave, rejoin = span
        if leave < ticks:
            events.append(Leave(leave, worker))
        if rejoin <= 0 or rejoin >= ticks:
            return None
        events.append(Join(rejoin, worker))
        return rejoin

    def timeline(self, k: int, ticks: int) -> tuple:
        """The ordered event stream of a barrier-free run over
        ``ticks`` wall-clock ticks: Arrival / Leave / Join / Lost
        events sorted by (tick, kind, worker) with Join first (a
        rejoining worker re-dispatches before same-tick arrivals
        apply). Pure function of the scenario — replaying a prefix and
        resuming mid-stream yields the identical suffix (the
        checkpoint-restore contract).

        Worker lifecycle: dispatch at tick t, compute finishes at
        t + speed; each send attempt pays its link latency (jittered);
        a dropped attempt retries after ``retry_backoff`` ticks, up to
        ``max_retries`` times, after which the payload is Lost and the
        worker continues from its OWN params under the same dispatch
        version (Fig 8 semantics — the next success recovers the lost
        mass because its delta spans both phases). On an Arrival the
        worker re-dispatches from the fresh global copy at the arrival
        tick. With zero faults and unit speeds this reduces exactly to
        the seed's tick loop.

        Preemption cuts the phase in flight; payloads still on the
        wire (or mid-retry) when their sender leaves are discarded by
        the server — so every Arrival is guaranteed to land on a
        worker that has been continuously present since the payload's
        dispatch, the invariant the async engine's slot bookkeeping
        asserts. A ``uid`` is consumed by every phase whose compute
        finished (delivered, Lost, or discarded), making uids stable
        identifiers across resumes.
        """
        speeds = self.resolved_speeds(k)
        lat = self.resolved_latency(k)
        pre = self._preempt_of(k)
        # one independent stream per worker: event generation for
        # worker i must not consume draws that belong to worker j, or
        # changing one worker's schedule would reshuffle everyone's
        rngs = [np.random.default_rng((self.seed, i)) for i in range(k)]
        events: list = []
        uid = 0
        for i in range(k):
            spans = list(pre.get(i, []))
            t = 0                      # current dispatch tick
            while t < ticks:
                nxt = spans[0] if spans else None
                finish = t + speeds[i]
                if nxt is not None and nxt[0] < finish:
                    # preemption cuts the phase mid-compute: no uid
                    spans.pop(0)
                    t = self._emit_preemption(events, i, nxt, ticks)
                    if t is None:
                        break
                    continue
                if finish > ticks:
                    break              # compute runs past the horizon
                arr, gave_up, attempt = self._resolve_send(
                    rngs[i], lat[i], finish)
                if arr is not None:
                    if nxt is not None and nxt[0] < arr:
                        # payload on the wire when the sender leaves:
                        # the server discards it (membership change)
                        uid += 1
                        spans.pop(0)
                        t = self._emit_preemption(events, i, nxt, ticks)
                        if t is None:
                            break
                        continue
                    if arr > ticks:
                        break          # in flight past the horizon
                    events.append(Arrival(arr, i, uid, t, finish,
                                          attempt))
                    uid += 1
                    t = arr            # re-dispatch from fresh global
                    continue
                # every attempt dropped: sender gives up at gave_up
                if nxt is not None and nxt[0] < gave_up:
                    uid += 1
                    spans.pop(0)
                    t = self._emit_preemption(events, i, nxt, ticks)
                    if t is None:
                        break
                    continue
                uid += 1
                if gave_up > ticks:
                    break              # still retrying at the horizon
                events.append(Lost(gave_up, i, uid - 1, t, finish))
                t = gave_up            # continue from own params
        if 0 <= int(self.crash_tick) < ticks:
            # the process dies AFTER the tick's worker events (the
            # crash observes them; sort key below puts it last) — and
            # consumes no rng/uid, so the crash-free timeline is this
            # one minus the Crash: a resume replays the exact suffix
            events.append(Crash(int(self.crash_tick)))
        order = {Join: 0, Arrival: 1, Lost: 2, Leave: 3, Crash: 4}
        events.sort(key=lambda e: (e.tick, order[type(e)],
                                   getattr(e, "worker", -1)))
        return tuple(events)


def staleness_weight(staleness, lam: float, k: int):
    """The async transport's delay-compensation policy: an outer
    gradient ``staleness`` outer steps late is applied at weight
    λ^staleness / k — 1/k is the worker's share of one synchronous
    round's evidence, λ^τ the discount. Monotone non-increasing in the
    delay for λ <= 1 (tested)."""
    if not 0.0 <= lam <= 1.0:
        raise ValueError(f"staleness lambda must be in [0, 1], "
                         f"got {lam}")
    return (lam ** staleness) / float(k)
