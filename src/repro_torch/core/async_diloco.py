"""Asynchronous DiLoCo, the paper's stated future work (§5): "extend
DiLoCo to the asynchronous setting, whereby workers update the global
parameter without ever waiting for any other worker". The JAX
``core/async_diloco.py`` in PyTorch.

The barrier-free engine (``AsyncEngine``), event-driven:

* A ``faults.Scenario`` scripts the failure model (heterogeneous worker
  speeds, per-link latency, outer-gradient drops with retry/backoff,
  preemptions that leave and rejoin) and compiles it to a deterministic
  timeline of Arrival / Lost / Leave / Join events.
* A parameter server holds the global copy θ and the outer optimizer's
  state. Whenever ANY worker's outer gradient arrives it is applied at
  once, at weight λ^τ / k (τ = outer steps since the worker's dispatch;
  ``faults.staleness_weight``).
* The delta Δ_i = θ^(dispatch) − θ_i is taken against the server's
  snapshot of the dispatch point, master against master under a mixed
  policy. Snapshots are keyed by version and pruned to the live dispatch
  versions.
* The delta (plus the worker's error-feedback residual) is ONE flat
  float32 payload in the JAX tree order (sorted keys), so int4 blocks of
  128 entries straddle two leaves wherever a leaf's size is not a
  multiple of 128, as JAX's ``ravel_pytree`` makes them. Under a
  quantized ``outer_grad_dtype`` it ships through the packed wire
  (``kernels.ops.wire_encode``/``wire_decode``: the ``quantize_pack_int4``
  and ``unpack_dequantize_int4`` kernels for int4) and the decoded value
  is applied; with ``cfg.error_feedback`` each worker keeps its residual
  across arbitrarily delayed applications. Float32 ships raw.
* A payload whose every send attempt drops is Lost: the worker keeps its
  own params under the SAME dispatch version, so its next delta spans
  both phases.

PyTorch idiom: the inner steps, the outer step and the residual update
write in place. The global params are updated in place by the outer
step, so every snapshot is a fresh copy, and a worker re-dispatched from
the global copies it into its own buffers: no worker and no snapshot
aliases the global (a stale arrival takes its delta against its own
snapshot). The flat payload is built leaf by leaf into one preallocated
buffer, and the applied update is handed to the outer optimizer as views
of it. Counters are host integers. Each phase's tokens come from a
``torch.Generator`` seeded from (seed, the timeline's uid), one
``sample_fn(gen, B, S)`` call per inner step, never from host call order,
as JAX keys each phase by ``fold_in(base_key, uid)``. The tokens differ
from JAX's (``jax.random`` is not reproduced); the parity tests hand both
packages JAX's tokens.

``run_async`` keeps the JAX package's one-call simulation API on top.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .. import tree
from ..configs.base import DiLoCoConfig, TrainConfig
from ..kernels import ops
from ..kernels.ref import device_scalar
from ..optim import adamw, precision
from . import diloco, faults, outer_opt


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@dataclass
class WorkerSlot:
    """One worker's server-side bookkeeping."""
    params: Any                 # working params (param_dtype)
    opt: adamw.AdamWState       # inner AdamW moments (+ master if mixed)
    residual: torch.Tensor      # flat float32 error-feedback residual
    version: int                # outer version of the dispatch point
    active: bool                # False between Leave and Join


@dataclass
class AsyncState:
    """Everything a barrier-free run carries between events."""
    global_params: Any
    outer: outer_opt.OuterState
    workers: list
    snapshots: dict             # live dispatch version -> θ snapshot
    version: int = 0            # outer step count (applications so far)
    inner_done: int = 0         # global inner-step counter (lr schedule)
    events_done: int = 0        # timeline cursor (resume point)

    def live_versions(self) -> set:
        return ({w.version for w in self.workers if w.active}
                | {self.version})


def state_to_tree(state: AsyncState) -> dict:
    """Flatten an AsyncState into a nested dict, the JAX ``state_to_tree``
    layout: tensors, int keys as strings, the step counts as int32 and
    the other counters as int64 numpy scalars."""
    workers = {}
    for i, w in enumerate(state.workers):
        d = {"params": w.params, "m": w.opt.m, "v": w.opt.v,
             "opt_count": np.int32(w.opt.count), "residual": w.residual,
             "version": np.int64(w.version),
             "active": np.int64(w.active)}
        if w.opt.master is not None:
            d["master"] = w.opt.master
        workers[str(i)] = d
    return {
        "global": state.global_params,
        "outer": {"buf": state.outer.buf, "buf2": state.outer.buf2,
                  "count": np.int32(state.outer.count)},
        "workers": workers,
        "snapshots": {str(v): s for v, s in state.snapshots.items()},
        "counters": {"version": np.int64(state.version),
                     "inner_done": np.int64(state.inner_done),
                     "events_done": np.int64(state.events_done)},
    }


def state_from_tree(tree_: dict, params_example) -> AsyncState:
    """Inverse of ``state_to_tree``: every params-shaped subtree is put
    back on ``params_example``'s structure (``tree.unflatten``)."""
    like = lambda t: tree.unflatten(params_example, tree.leaves(t))
    workers = []
    for i in range(len(tree_["workers"])):
        d = tree_["workers"][str(i)]
        opt = adamw.AdamWState(
            m=like(d["m"]), v=like(d["v"]), count=int(d["opt_count"]),
            master=like(d["master"]) if "master" in d else None)
        workers.append(WorkerSlot(
            params=like(d["params"]), opt=opt, residual=d["residual"],
            version=int(d["version"]), active=bool(int(d["active"]))))
    return AsyncState(
        global_params=like(tree_["global"]),
        outer=outer_opt.OuterState(
            buf=like(tree_["outer"]["buf"]),
            buf2=like(tree_["outer"]["buf2"]),
            count=int(tree_["outer"]["count"])),
        workers=workers,
        snapshots={int(v): like(s)
                   for v, s in tree_["snapshots"].items()},
        version=int(tree_["counters"]["version"]),
        inner_done=int(tree_["counters"]["inner_done"]),
        events_done=int(tree_["counters"]["events_done"]),
    )


def phase_seed(seed: int, uid: int) -> int:
    """The seed of the phase with timeline ``uid`` (a 63-bit integer drawn
    by numpy's ``SeedSequence`` from (seed, uid))."""
    state = np.random.SeedSequence([int(seed), int(uid)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


class _DrawTimer:
    """Times the token draws of one phase without a host sync: on a CUDA
    device a pair of CUDA events around each draw, read by ``seconds``
    once the caller has synchronized (the draw's device time); on the CPU
    the host clock around each draw."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pairs, self.host_s = [], 0.0

    def __enter__(self):
        if self.cuda:
            self.pairs.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
            self.pairs[-1][0].record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.pairs[-1][1].record()
        else:
            self.host_s += time.perf_counter() - self._t0
        return False

    def seconds(self) -> float:
        """The draws' seconds; on the card, after a synchronize."""
        return self.host_s + sum(a.elapsed_time(b)
                                 for a, b in self.pairs) / 1e3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class AsyncEngine:
    """Barrier-free DiLoCo driven by a ``faults.Scenario`` timeline.

    sample_fn(gen, B, S) -> (B, S) tokens, one worker's batch (pass a
    tuple of k callables for per-worker data shards); ``gen`` is the
    phase's ``torch.Generator`` on the params' device.

    ``donate`` is accepted for the JAX package's call sites and changes
    nothing: the port updates its state in place either way.

    ``timing`` holds, per phase event, the host seconds of its inner
    phase (``phase_s``), of that the token sampling (``sample_s``: each
    step's draw between two CUDA events on the card, read after the
    phase's closing synchronize, so the phase has no host sync inside its
    H steps; the host clock on the CPU), and of its application
    (``apply_s``: the flat payload, the wire, the outer step, the
    snapshot and the re-dispatch), each closed by a device synchronize.
    """

    def __init__(self, loss_fn: Callable, sample_fn, cfg: DiLoCoConfig,
                 tcfg: TrainConfig, *, scenario: faults.Scenario | None
                 = None, total_steps: int | None = None,
                 eval_fn=None, eval_tokens=None, seed: int = 0,
                 donate: bool = True):
        if cfg.outer_grad_dtype not in ("float32", "bfloat16", "int4"):
            raise ValueError(
                f"unsupported outer_grad_dtype {cfg.outer_grad_dtype!r}")
        if getattr(cfg, "streaming_fragments", 0):
            raise ValueError(
                "transport='async' replaces the round schedule "
                "entirely; streaming_fragments must be 0")
        # validate λ eagerly (shared with the weight policy)
        faults.staleness_weight(0, cfg.staleness_lambda, cfg.k)
        self.cfg, self.tcfg = cfg, tcfg
        self.scenario = scenario or faults.Scenario.uniform(cfg.k)
        self.scenario.resolved_speeds(cfg.k)     # fail fast on shape
        self.eval_fn, self.eval_tokens = eval_fn, eval_tokens
        self.seed = int(seed)
        self.donate = bool(donate)
        self._pol = precision.policy_of(cfg)
        self._mode = getattr(cfg, "kernel_mode", "auto")
        self._layout = None                      # set on first init
        self._n_elems = None
        self.loss_fn = loss_fn
        self._inner_step = diloco.make_inner_step(
            lambda p, b: loss_fn(p, b), tcfg,
            total_steps or tcfg.total_steps)
        samplers = (tuple(sample_fn) if isinstance(sample_fn,
                                                   (tuple, list))
                    else (sample_fn,) * cfg.k)
        if len(samplers) != cfg.k:
            raise ValueError(
                f"need {cfg.k} per-worker samplers, got {len(samplers)}")
        self._samplers = samplers
        self.timing: list = []

    # ---- state construction ----

    def _dispatch(self, global_params):
        """A fresh worker dispatch from θ: a copy of θ at the working
        dtype and brand-new AdamW moments (a new or rejoining worker)."""
        disp = precision.cast_tree(global_params, self._pol.param_dtype,
                                   fresh=True)
        return disp, adamw.init(global_params, policy=self._pol)

    def _redispatch(self, w: WorkerSlot, global_params):
        """A survivor re-dispatched from θ: θ copied into its own working
        buffers (``copy_`` rounds to the working dtype), its moments kept,
        and its master (mixed policy) re-pointed at a copy of θ."""
        with torch.no_grad():
            for p, g in zip(tree.leaves(w.params),
                            tree.leaves(global_params)):
                p.copy_(g)
            if w.opt.master is not None:
                for m, g in zip(tree.leaves(w.opt.master),
                                tree.leaves(global_params)):
                    m.copy_(g)

    def init_state(self, params0) -> AsyncState:
        self._bind_params(params0)
        workers = []
        for _ in range(self.cfg.k):
            p, o = self._dispatch(params0)
            workers.append(WorkerSlot(
                params=p, opt=o, residual=self._zeros(params0),
                version=0, active=True))
        return AsyncState(
            global_params=tree.map(torch.clone, params0),
            outer=outer_opt.init(params0),
            workers=workers,
            snapshots={0: tree.map(torch.clone, params0)})

    def _bind_params(self, params):
        leaves = tree.leaves(params)
        sizes = [x.numel() for x in leaves]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        self._layout = [(tuple(x.shape), int(o), int(n))
                        for x, o, n in zip(leaves, offsets, sizes)]
        self._n_elems = int(offsets[-1])
        self._device = leaves[0].device

    def _bind(self, state: AsyncState):
        """Bind the flat layout to a state built elsewhere (a restore)."""
        if self._layout is None:
            self._bind_params(state.global_params)

    def _zeros(self, like):
        return torch.zeros((self._n_elems,), dtype=torch.float32,
                           device=tree.leaves(like)[0].device)

    def wire_bytes(self) -> float:
        """Bytes ONE application ships worker→server (packed wire for the
        quantized dtypes, raw float32 otherwise)."""
        return ops.transport_bytes(
            self._n_elems, self.cfg.outer_grad_dtype,
            packed=self.cfg.outer_grad_dtype != "float32")

    # ---- the application ----

    def _apply(self, state: AsyncState, msrc, residual, snapshot,
               weight: float):
        """Apply one arrival: in place on the global params, the outer
        state and ``residual``. Returns the decoded payload's norm (a
        device scalar)."""
        cfg, mode = self.cfg, self._mode
        dt = cfg.outer_grad_dtype
        # Δ = θ^(dispatch) − θ_i, master against master, as ONE flat
        # payload in the tree order; then d_tot = Δ + residual
        d = torch.empty((self._n_elems,), dtype=torch.float32,
                        device=residual.device)
        with torch.no_grad():
            for (_, off, n), s, w in zip(self._layout,
                                         tree.leaves(snapshot),
                                         tree.leaves(msrc)):
                torch.sub(s.reshape(-1), w.reshape(-1).to(torch.float32),
                          out=d[off:off + n])
            d.add_(residual)
            if dt == "float32":
                local = d                               # raw f32 wire
            else:
                wire, _ = ops.wire_encode(d, dt, mode=mode,
                                          with_local=False)
                local = ops.wire_decode(wire, self._n_elems, dt,
                                        mode=mode)
                del wire
            if cfg.error_feedback:
                torch.sub(d, local, out=residual)
            else:
                residual.zero_()
            dnorm = torch.linalg.vector_norm(local)
            # the weight multiplies the decoded payload, in float32,
            # before the outer step (local may be d: it is not read again)
            applied = torch.mul(local, device_scalar(weight, local),
                                out=local)
            applied_tree = tree.unflatten(
                state.global_params,
                [applied[off:off + n].view(shape)
                 for shape, off, n in self._layout])
            state.global_params, state.outer = outer_opt.update(
                applied_tree, state.outer, state.global_params,
                kind=cfg.outer_opt, lr=cfg.outer_lr,
                momentum=cfg.outer_momentum, b2=cfg.outer_adam_b2,
                eps=cfg.outer_adam_eps, kernel_mode=mode)
        return dnorm

    # ---- event loop ----

    def _prune(self, state: AsyncState):
        """Drop snapshots no live dispatch can still reference. A live
        version must never be dropped."""
        live = state.live_versions()
        missing = live - set(state.snapshots)
        assert not missing, f"live dispatch versions {missing} pruned"
        state.snapshots = {v: s for v, s in state.snapshots.items()
                           if v in live}

    def run(self, state: AsyncState, *, ticks: int,
            max_events: int | None = None, recorder=None,
            on_crash=None):
        """Process the scenario timeline for ``ticks`` wall-clock ticks
        from ``state.events_done``, optionally stopping after
        ``max_events`` more events. Returns (state, history): one record
        per event, keyed by ``"event"``. ``recorder`` (an
        ``obs.metrics.RunRecorder``) receives each record as it happens
        (host-side only). ``on_crash(state)`` is called when a
        ``faults.Crash`` event is reached; if it returns, the run goes on.
        """
        cfg = self.cfg
        self._bind(state)
        events = self.scenario.timeline(cfg.k, ticks)
        todo = events[state.events_done:]
        if max_events is not None:
            todo = todo[:max_events]
        history = []

        def emit(rec):
            history.append(rec)
            if recorder is not None:
                recorder.async_event(rec)

        for ev in todo:
            if isinstance(ev, faults.Arrival):
                emit(self._on_arrival(state, ev))
            elif isinstance(ev, faults.Lost):
                emit(self._on_lost(state, ev))
            elif isinstance(ev, faults.Leave):
                w = state.workers[ev.worker]
                w.active = False
                self._prune(state)
                emit({"event": "leave", "tick": ev.tick,
                      "worker": ev.worker})
            elif isinstance(ev, faults.Crash):
                emit({"event": "crash", "tick": ev.tick})
                state.events_done += 1
                if on_crash is not None:
                    on_crash(state)
                continue
            elif isinstance(ev, faults.Join):
                w = state.workers[ev.worker]
                # moments died with the preemption: fresh opt, fresh
                # residual, dispatch from the current global copy
                w.params, w.opt = self._dispatch(state.global_params)
                w.residual = self._zeros(state.global_params)
                w.version = state.version
                w.active = True
                emit({"event": "join", "tick": ev.tick,
                      "worker": ev.worker,
                      "version": state.version})
            state.events_done += 1
        return state, history

    def _phase(self, state: AsyncState, ev):
        """The H inner steps of the phase ``ev`` reports, in place on the
        worker's params and moments, on tokens drawn from the phase's own
        generator (seeded from the uid). Returns (worker, mean loss, the
        sampling's timer): the phase makes no host sync, so on the card
        each draw is timed by CUDA events, read by ``sample_seconds``
        after the caller's synchronize; on the CPU by the host clock."""
        w = state.workers[ev.worker]
        assert w.active, (
            f"arrival for departed worker {ev.worker}: the timeline "
            "guarantees delivered payloads outlive their sender")
        dev = self._device
        gen = torch.Generator(device=dev)
        gen.manual_seed(phase_seed(self.seed, ev.uid))
        tc = self.tcfg
        p, o, losses, timer = w.params, w.opt, [], _DrawTimer(dev)
        for h in range(self.cfg.H):
            with timer:
                batch = {"tokens": self._samplers[ev.worker](
                    gen, tc.batch_size, tc.seq_len)}
            p, o, m = self._inner_step(p, o, batch, state.inner_done + h)
            losses.append(m["loss"])
        w.params, w.opt = p, o
        state.inner_done += self.cfg.H
        return w, torch.stack(losses).mean(), timer

    def _on_arrival(self, state: AsyncState, ev):
        cfg = self.cfg
        t0 = time.perf_counter()
        w, mloss, timer = self._phase(state, ev)
        _sync(self._device)
        t1 = time.perf_counter()
        sample_s = timer.seconds()
        staleness = state.version - w.version
        weight = faults.staleness_weight(staleness,
                                         cfg.staleness_lambda, cfg.k)
        dnorm = self._apply(state, adamw.master_params(w.params, w.opt),
                            w.residual, state.snapshots[w.version], weight)
        state.version += 1
        # snapshot the new θ (a fresh copy: the next application updates
        # the global in place), then re-dispatch the worker from it
        state.snapshots[state.version] = tree.map(torch.clone,
                                                  state.global_params)
        self._redispatch(w, state.global_params)
        w.version = state.version
        self._prune(state)
        _sync(self._device)
        self.timing.append({"event": "arrival", "phase_s": t1 - t0,
                            "sample_s": sample_s,
                            "apply_s": time.perf_counter() - t1})
        rec = {"event": "arrival", "tick": ev.tick, "worker": ev.worker,
               "uid": ev.uid, "attempt": ev.attempt,
               "staleness": staleness, "weight": float(weight),
               "version": state.version, "inner_loss": float(mloss),
               "delta_norm": float(dnorm),
               "wire_bytes": self.wire_bytes()}
        if self.eval_fn is not None and self.eval_tokens is not None:
            rec["val_loss"] = float(self.eval_fn(state.global_params,
                                                 self.eval_tokens))
            rec["ppl"] = float(np.exp(rec["val_loss"]))
        return rec

    def _on_lost(self, state: AsyncState, ev):
        """Every send attempt dropped: the phase ran but its delta never
        reached the server. The worker keeps its own params under the
        SAME dispatch version, so the next arrival's delta spans both
        phases; the error-feedback residual is untouched (nothing was
        quantized onto the wire)."""
        t0 = time.perf_counter()
        w, mloss, timer = self._phase(state, ev)
        _sync(self._device)
        self.timing.append({"event": "lost",
                            "phase_s": time.perf_counter() - t0,
                            "sample_s": timer.seconds(), "apply_s": 0.0})
        return {"event": "lost", "tick": ev.tick, "worker": ev.worker,
                "uid": ev.uid, "version_at_dispatch": w.version,
                "inner_loss": float(mloss)}


# ---------------------------------------------------------------------------
# the JAX package's one-call simulation API
# ---------------------------------------------------------------------------

@dataclass
class AsyncConfig:
    k: int = 8
    H: int = 10
    outer_lr: float = 0.7
    outer_momentum: float = 0.9
    staleness_lambda: float = 0.7   # discount per outer step of delay
    speeds: tuple = ()              # ticks per phase, len k (default 1s)


def run_async(loss_fn: Callable, sample_fn: Callable, params0,
              acfg: AsyncConfig, tcfg: TrainConfig, *, ticks: int,
              eval_fn=None, eval_tokens=None, seed: int = 0,
              scenario: faults.Scenario | None = None,
              dcfg: DiLoCoConfig | None = None, donate: bool = True):
    """Simulate ``ticks`` wall-clock units of barrier-free DiLoCo; one
    tick = the fastest worker's phase time. Returns (global_params,
    history): one dict per Arrival (plus the lost/leave/join records
    under a faulty ``scenario``). ``dcfg`` overrides the DiLoCoConfig
    derived from ``acfg``; ``donate`` changes nothing (``AsyncEngine``)."""
    if dcfg is None:
        dcfg = DiLoCoConfig(
            k=acfg.k, H=acfg.H, outer_lr=acfg.outer_lr,
            outer_momentum=acfg.outer_momentum, transport="async",
            staleness_lambda=acfg.staleness_lambda)
    if scenario is None:
        scenario = faults.Scenario(speeds=tuple(acfg.speeds)
                                   or (1,) * acfg.k)
    eng = AsyncEngine(loss_fn, sample_fn, dcfg, tcfg,
                      scenario=scenario, eval_fn=eval_fn,
                      eval_tokens=eval_tokens, seed=seed, donate=donate)
    state = eng.init_state(params0)
    state, history = eng.run(state, ticks=ticks)
    arrivals = [r for r in history if r["event"] == "arrival"]
    return state.global_params, (arrivals if scenario.drop_prob == 0
                                 and not scenario.preemptions
                                 else history)
