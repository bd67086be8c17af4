"""DiLoCo training driver (CLI), the synchronous path of the JAX
``launch/train.py``: an optional single-worker pretraining phase, then
T rounds of (H inner AdamW steps × k replicas + one outer Nesterov
step), with the paper's data regimes, communication drops, adaptive
compute schedules and outer optimizers.

It takes the JAX driver's flags and prints its console and ``--out``
JSON lines. Two flags differ: ``--device`` (default ``cuda``; a run on
the CPU is asked for with ``--device cpu``) and ``--kernel-mode``
(``auto`` by default: the CUDA kernels on CUDA tensors, their plain
PyTorch versions on the CPU). Flags of transports and features that are
not ported exit with a message that names their ROADMAP.md item. With
``--prune-frac`` each round's record also carries ``prune_density``, the
share of the outer-gradient entries kept. ``--stream-fragments P`` runs
streaming DiLoCo on the simulated transport (``core/streaming.py``:
``--stream-tau``, ``--stream-alpha``, ``--outer-grad-dtype``,
``--error-feedback``); its records carry ``stream_peak_sync_bytes`` and
``stream_round_sync_bytes``. ``--transport sharded --pods N`` runs the
same streaming rounds on N pod ranks that the trainer starts itself
(``launch/mesh.py``, ``core/pod_collectives.py``), each fragment reduced
by a real ``torch.distributed`` collective (the packed int4 or bf16 wire
unless ``--no-pack-wire``). ``--transport async`` runs barrier-free
DiLoCo (``core/async_diloco.py``) over ``--ticks`` wall-clock ticks of a
fault scenario (``core/faults.py``: ``--speeds``, ``--link-latency``,
``--latency-jitter``, ``--drop-prob`` with any other fault flag,
``--max-retries``, ``--retry-backoff``, ``--preempt``), each outer
gradient applied at weight ``--staleness-lambda``^τ / k, shipped at
``--outer-grad-dtype`` with or without ``--error-feedback``; it prints
one line per event. On the round transports the same fault flags are
projected onto the rounds' drop and active masks.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --full --arch diloco_150m --k 2 --H 4 --rounds 2 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch diloco_150m --param-dtype bfloat16 --master-dtype float32 \\
      --prune-frac 0.5 --k 2 --H 4 --rounds 2 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch diloco_150m --stream-fragments 4 --stream-tau 2 \\
      --stream-alpha 0.5 --outer-grad-dtype int4 --error-feedback \\
      --k 2 --H 4 --rounds 2 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch diloco_150m --transport sharded --pods 2 \\
      --stream-fragments 4 --stream-tau 2 --stream-alpha 0.5 \\
      --outer-grad-dtype int4 --error-feedback \\
      --k 2 --H 4 --rounds 2 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --full \\
      --arch diloco_150m --transport async --speeds 1,2 \\
      --staleness-lambda 0.7 --outer-grad-dtype int4 --error-feedback \\
      --k 2 --H 4 --rounds 2 --batch 8 --seq 1024
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import DiLoCoConfig, TrainConfig
from ..core import (async_diloco, diloco, faults, pod_collectives,
                    schedules, streaming)
from ..data.sharding import make_regime, shard_weights
from ..kernels import ops as kops
from ..models.registry import get_arch, get_smoke_arch
from ..obs import metrics as obs_metrics
from ..optim import adamw, precision
from . import mesh

# flag dest -> the ROADMAP.md port-queue item that ports it. A flag left
# at its default passes; any other value exits with the item's name.
UNPORTED = {
    "gossip_pairing": "transports", "gossip_mix": "transports",
    "crash_at_round": "fault scenarios", "crash_at_tick": "fault scenarios",
    "nan_bomb": "fault scenarios",
    "restore": "checkpoints and resilience",
    "checkpoint": "checkpoints and resilience",
    "checkpoint_dir": "checkpoints and resilience",
    "checkpoint_every": "checkpoints and resilience",
    "resume": "checkpoints and resilience",
    "retain": "checkpoints and resilience",
    "state_hash_out": "checkpoints and resilience",
    "guard": "checkpoints and resilience",
    "guard_window": "checkpoints and resilience",
    "guard_spike": "checkpoints and resilience",
    "guard_rollbacks": "checkpoints and resilience",
    "trace": "telemetry",
}
# transports of the JAX trainer that are not ported
UNPORTED_TRANSPORTS = ("gossip",)


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; asking for CUDA without a GPU raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is visible. The port runs on "
            "the GPU by default; pass --device cpu to run on the CPU")
    return dev


def _int_list(spec: str, k: int, name: str) -> tuple:
    """Parse a comma list of ints; a single value broadcasts to k."""
    try:
        vals = [int(x) for x in spec.split(",") if x.strip()]
    except ValueError:
        raise SystemExit(f"{name} wants comma-separated ints, "
                         f"got {spec!r}")
    if len(vals) == 1:
        vals = vals * k
    if len(vals) != k:
        raise SystemExit(f"{name} needs 1 or k={k} values, "
                         f"got {len(vals)}")
    return tuple(vals)


def scenario_of(args) -> faults.Scenario | None:
    """The ``faults.Scenario`` scripted by the fault flags, or None when
    no fault flag is set (the i.i.d. drop-mask path keeps its exact rng
    stream), as the JAX trainer builds it.

    Round transports project the scenario onto per-round masks
    (``Scenario.round_masks``); the async engine consumes its event
    timeline. ``--drop-prob`` alone does NOT make a scenario; combined
    with any other fault flag it becomes the scenario's per-send drop
    probability with retry/backoff semantics. The crash and NaN-bomb
    injections the JAX scenario also carries are refused by
    ``check_ported`` (ROADMAP.md, port queue: fault scenarios).
    """
    used = (args.speeds or args.link_latency
            or args.latency_jitter > 0 or args.max_retries > 0
            or args.preempt or args.transport == "async")
    if not used:
        return None
    k = args.k
    preempts = []
    for spec in args.preempt:
        parts = spec.split(":")
        if len(parts) not in (2, 3):
            raise SystemExit(
                f"--preempt wants WORKER:LEAVE[:REJOIN], got {spec!r}")
        w, leave = int(parts[0]), int(parts[1])
        rejoin = int(parts[2]) if len(parts) == 3 else 0
        preempts.append((w, leave, rejoin))
    return faults.Scenario(
        speeds=_int_list(args.speeds, k, "--speeds")
        if args.speeds else (1,) * k,
        latency=_int_list(args.link_latency, k, "--link-latency")
        if args.link_latency else (),
        latency_jitter=args.latency_jitter,
        drop_prob=args.drop_prob,
        max_retries=args.max_retries,
        retry_backoff=args.retry_backoff,
        preemptions=tuple(preempts),
        seed=args.seed)


def eval_rounds(rounds: int, eval_every: int, *, legacy_loop: bool,
                rounds_per_call: int) -> list:
    """Per round (0-based), whether the JAX trainer reports a val loss
    for it: every round under ``--legacy-loop`` (one eval per dispatch,
    ``repro/launch/train.py:554-566``); else, in chunks of
    ``--rounds-per-call`` rounds (0: all rounds in one call), the rounds
    g = t + 1 with g % eval_every == 0 and the last round of every chunk
    (``repro/core/diloco.py:513-517``)."""
    if legacy_loop:
        return [True] * rounds
    rpc = max(1, min(rounds_per_call or rounds, rounds))
    return [(t + 1) % eval_every == 0 or (t + 1) % rpc == 0
            or t == rounds - 1 for t in range(rounds)]


def check_ported(args, parser=None):
    """Refuse what the port does not run (naming its ROADMAP.md item),
    then the JAX trainer's own validation of the flags it runs."""
    parser = parser or make_parser()
    bad = [f"--{dest.replace('_', '-')} (ROADMAP.md, port queue: "
           f"{item})" for dest, item in UNPORTED.items()
           if getattr(args, dest) != parser.get_default(dest)]
    if args.transport in UNPORTED_TRANSPORTS:
        bad.insert(0, f"--transport {args.transport} (ROADMAP.md, port "
                      "queue: transports)")
    if bad:
        raise SystemExit("not ported yet: " + "; ".join(bad))
    if args.kernel_mode in ("pallas", "interpret"):
        raise SystemExit(f"--kernel-mode {args.kernel_mode} names TPU "
                         "(Pallas) machinery; the port's modes are "
                         "auto|kernel|ref")
    if args.guard_clip > 0 and not args.guard_outer:
        raise SystemExit("--guard-clip scales deltas inside the in-graph "
                         "guard; add --guard-outer")
    if not args.stream_fragments and args.transport in ("simulated",
                                                        "sharded"):
        # these knobs act only on the streaming outer path: running the
        # classic float32 outer step while the command line says "int4"
        # would mislabel every reported number (the JAX driver's check)
        ignored = [flag for flag, on in (
            ("--outer-grad-dtype", args.outer_grad_dtype != "float32"),
            ("--stream-alpha", args.stream_alpha != 1.0),
            ("--stream-tau", args.stream_tau != 0),
            ("--error-feedback", args.error_feedback),
            ("--transport", args.transport != "simulated"),
            ("--no-pack-wire", not args.pack_wire),
            ("--pods", args.pods != 0)) if on]
        if ignored:
            raise SystemExit(
                f"{', '.join(ignored)} require(s) --stream-fragments "
                ">= 1 (streaming outer sync); the classic outer step "
                "would ignore them")
    if args.transport == "async":
        # streaming mechanics that have no meaning off the fragment-round
        # path are rejected, not ignored (the JAX trainer's check)
        bad = [flag for flag, on in (
            ("--stream-fragments", args.stream_fragments != 0),
            ("--stream-alpha", args.stream_alpha != 1.0),
            ("--stream-tau", args.stream_tau != 0),
            ("--no-pack-wire", not args.pack_wire),
            ("--pods", args.pods != 0),
            ("--legacy-loop", args.legacy_loop),
            ("--cosine-stats", args.cosine_stats)) if on]
        if bad:
            raise SystemExit(f"{', '.join(bad)} do(es) not act on "
                             f"--transport {args.transport}")
    if args.pods and args.transport != "sharded":
        # --pods only shapes the sharded transport's pod group; accepting
        # it on the simulated path would fake a multi-pod layout
        raise SystemExit("--pods requires --transport sharded")
    if args.transport == "sharded" and args.cosine_stats:
        raise SystemExit("--cosine-stats (compute_cosine) needs cross-pod "
                         "delta gathers; run it on --transport simulated")


def build(args, device, sampler=None):
    """(arch, its config, DiLoCoConfig, TrainConfig, sampler) of ``args``;
    the Markov sampler is built on ``device`` unless one is given."""
    arch = (get_smoke_arch if args.smoke else get_arch)(args.arch)
    cfg = arch.cfg
    dcfg = DiLoCoConfig(k=args.k, H=args.H, outer_opt=args.outer_opt,
                        outer_lr=args.outer_lr,
                        outer_momentum=args.outer_momentum,
                        drop_prob=args.drop_prob,
                        prune_frac=args.prune_frac,
                        weighted_avg=args.weighted,
                        kernel_mode=args.kernel_mode,
                        param_dtype=args.param_dtype,
                        master_dtype=args.master_dtype,
                        guard_outer=args.guard_outer,
                        guard_clip=args.guard_clip,
                        streaming_fragments=args.stream_fragments,
                        stream_alpha=args.stream_alpha,
                        stream_tau=args.stream_tau,
                        outer_grad_dtype=args.outer_grad_dtype,
                        error_feedback=args.error_feedback,
                        transport=args.transport,
                        pack_wire=args.pack_wire,
                        staleness_lambda=args.staleness_lambda)
    total = args.pretrain_steps + args.rounds * args.H
    tcfg = TrainConfig(inner_lr=args.inner_lr, warmup_steps=args.warmup,
                       total_steps=total, batch_size=args.batch,
                       seq_len=args.seq, seed=args.seed,
                       kernel_mode=args.kernel_mode,
                       param_dtype=args.param_dtype,
                       master_dtype=args.master_dtype)
    if sampler is None:
        sampler = make_regime(args.regime, k=args.k,
                              vocab_size=cfg.vocab_size, seed=args.seed,
                              imbalanced=args.weighted, device=device)
    return arch, cfg, dcfg, tcfg, sampler


def run(args, recorder=None, *, sampler=None):
    """Drive the configured run end-to-end. Returns the record history;
    ``recorder.manifest["timing"]`` holds the host seconds of the data
    set-up and of each round's sampling, inner phase and outer step.
    ``sampler``: Markov tables already built for these arguments (the
    same regime, k, vocabulary, seed and weighting), used instead of
    building them again; on the device, or copied there.
    ``--transport sharded`` starts its pod ranks itself (``run_sharded``)."""
    check_ported(args)
    device = resolve_device(args.device)
    if args.transport == "sharded":
        return run_sharded(args, device, recorder, sampler=sampler)
    return _train(args, device, recorder,
                  sampler=None if sampler is None else sampler.to(device))


def _train(args, device, recorder=None, *, group=None, sampler=None,
           data_setup_s=None, note=None):
    """The run on ``device``; on the sharded transport, one pod rank's
    part of it (``group``; the sampler and its set-up seconds come from
    the parent). Only the lead process (rank 0) evaluates."""
    t_setup = time.perf_counter()
    arch, cfg, dcfg, tcfg, sampler = build(args, device, sampler=sampler)
    if data_setup_s is None:
        data_setup_s = time.perf_counter() - t_setup
    lead = group is None or group.rank == 0
    loss_fn = lambda p, b: arch.loss(p, b)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = arch.init(generator=gen, device=device)
    ev = diloco.make_eval(loss_fn)
    val_gen = torch.Generator(device=device)
    val_gen.manual_seed(10_000)
    val = sampler.sample_validation(val_gen, args.eval_batch, args.seq)
    rec = recorder if recorder is not None else obs_metrics.RunRecorder(
        transport=args.transport, log_format=args.log_format)
    rec.manifest.setdefault("config", dict(vars(args)))
    evaluate = (lambda p: float(ev(p, val))) if lead else \
        (lambda p: float("nan"))

    # ---- pretraining phase (paper: 24k steps before DiLoCo) ----
    if args.pretrain_steps:
        step = diloco.make_single_worker_step(loss_fn, tcfg,
                                              total_steps=tcfg.total_steps)
        pol = precision.policy_of(tcfg)
        opt = adamw.init(params, policy=pol)
        # the working copy at param_dtype, a fresh buffer even when the
        # cast is the identity (the step updates it in place)
        work = precision.cast_tree(params, pol.param_dtype, fresh=True)
        for i in range(args.pretrain_steps):
            batch = {"tokens": sampler.sample_validation(
                gen, args.batch, args.seq)}
            work, opt, m = step(work, opt, batch, i)
            if (i + 1) % args.log_every == 0:
                rec.pretrain(step=i + 1, loss=float(m["loss"]),
                             val_loss=evaluate(work))
        # hand the master-precision params to the DiLoCo phase (the
        # working copy is a rounded view under a mixed policy); the upcast
        # keeps the globals and outer state float32 under the pure-bf16
        # policy, where no master exists
        params = precision.cast_tree(adamw.master_params(work, opt),
                                     torch.float32)
        del work, opt

    # ---- DiLoCo phase ----
    timing = {"device": str(device), "data_setup_s": data_setup_s}
    rec.manifest["timing"] = timing
    if dcfg.transport == "async":
        return _run_async_phase(args, dcfg, tcfg, loss_fn, sampler, params,
                                ev, val, rec)
    if dcfg.streaming_fragments:
        state = streaming.init_state(params, dcfg, group=group)
        plan = streaming.sync_plan(params, dcfg)
        round_wire = sum(row["wire_bytes"] for row in plan)
    else:
        state = diloco.init_state(params, dcfg)
        round_wire = diloco.outer_wire_bytes(params, dcfg)
        plan = [{"fragment": 0, "send_step": args.H, "apply_step": args.H,
                 "wire_bytes": float(round_wire),
                 "wire_dtype": dcfg.outer_grad_dtype}]
    rec.attach_wire_plan(plan)
    if note:
        rec.note(note)
    rng = np.random.default_rng(args.seed)
    drops = schedules.drop_masks(rng, args.drop_prob, args.k, args.rounds)
    acts = schedules.active_masks(
        schedules.compute_schedule(args.compute_schedule, args.k,
                                   args.rounds), args.k)
    scen = scenario_of(args)
    if scen is not None:
        # project the scripted fault scenario onto the barrier-paced run:
        # scenario drops (with retry semantics) replace the i.i.d. masks;
        # preemption spans compose with the compute schedule's masks
        drops, s_acts = scen.round_masks(args.k, args.rounds)
        acts = np.asarray(acts) * s_acts
        rec.note(f"faults: barrier round = "
                 f"{scen.sync_round_ticks(args.k)} "
                 "tick(s) (slowest worker + slowest link)")
    weights = shard_weights(sampler, args.weighted)
    rnd = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                            total_steps=tcfg.total_steps,
                            compute_cosine=args.cosine_stats,
                            batch_size=args.batch, seq_len=args.seq,
                            group=group)
    timing["rounds"] = []
    evals = eval_rounds(args.rounds, args.eval_every,
                        legacy_loop=args.legacy_loop,
                        rounds_per_call=args.rounds_per_call)

    t0 = time.time()
    for t in range(args.rounds):
        state, m = rnd(state, gen, drops[t], acts[t], weights)
        evaled = evals[t]
        val_loss = evaluate(state.global_params) if evaled \
            else float("nan")
        extras = {kk: float(m[kk]) for kk in (
            "inner_loss_last", "drop_frac", "prune_density",
            "stream_peak_sync_bytes", "stream_round_sync_bytes") if kk in m}
        if args.cosine_stats:
            extras["cos_mean"] = float(m["cos_mean"])
            extras["cos_std"] = float(m["cos_std"])
        rec.round(round=t + 1, rounds=args.rounds,
                  inner_steps=args.pretrain_steps + (t + 1) * args.H,
                  inner_loss=float(m["inner_loss"]), val_loss=val_loss,
                  outer_gnorm=float(m["outer_gnorm"]),
                  active=int(np.asarray(acts[t]).sum()),
                  dropped=int(args.k - np.asarray(drops[t]).sum()),
                  wire_bytes=round_wire, extras=extras, evaled=evaled)
        timing["rounds"].append({kk: m[kk] for kk in (
            "sample_s", "inner_s", "outer_s", "wait_s") if kk in m})

    floor = sampler.entropy_floor()
    rec.note(f"done in {time.time() - t0:.1f}s; "
             f"entropy floor = {floor:.4f} (ppl {np.exp(floor):.2f})")
    if args.out and group is None:
        rec.dump(args.out, args=vars(args))
        rec.note(f"wrote {args.out}")
    return rec.records


def run_sharded(args, device, recorder=None, *, sampler=None):
    """``--transport sharded``: lay ``--pods`` ranks over the visible
    cards (or the CPU), build the Markov tables once, here, and hand them
    to the ranks (shared memory on the CPU, CUDA IPC on a card; a rank on
    another card copies them), then run ``sharded_rank`` on every rank
    (``launch/mesh.spawn``). Rank 0 prints and records; its records are
    returned and land in ``recorder``, whose ``manifest["ranks"]`` holds
    every rank's device, kernel launches, collective traffic, timing and
    peak device memory. A failure in any rank fails the run."""
    n_dev = mesh.visible_devices(device.type)
    pods = args.pods or mesh.default_pods(args.k, n_dev)
    if pods < 2:
        raise SystemExit(
            "--transport sharded needs >= 2 pods, but no pod count >= 2 "
            f"divides k={args.k} and tiles the {n_dev} visible device(s) "
            "— a 1-pod group would run zero real cross-pod collectives")
    pod_collectives.check_bands(args.k, pods)
    layout = mesh.make_pod_layout(pods, device.type)
    where = (f"{mesh.chips_of(layout)} card(s)" if device.type == "cuda"
             else "the CPU")
    note = (f"sharded transport: {pods} pods × {args.k // pods} "
            f"replicas/pod on {where}"
            + (", every rank on the one card" if device.type == "cuda"
               and mesh.chips_of(layout) == 1 else "")
            + f"; {mesh.describe(layout)}")
    t0 = time.perf_counter()
    first = torch.device(layout.devices[0])
    sampler = build(args, first)[4] if sampler is None else sampler.to(first)
    setup_s = time.perf_counter() - t0
    results = mesh.spawn("repro_torch.launch.train:sharded_rank", layout,
                         args, sampler, setup_s, note)
    if device.type == "cuda":
        torch.cuda.ipc_collect()       # the ranks' handles on the tables
    # rank 0 printed the run's lines; this recorder takes its records
    rec = recorder if recorder is not None else obs_metrics.RunRecorder(
        transport=args.transport, log_format=args.log_format)
    rec.records[:] = results[0]["records"]
    rec.manifest.update(results[0]["manifest"])
    rec.manifest["ranks"] = [{kk: r[kk] for kk in (
        "rank", "device", "launches", "traffic", "timing",
        "max_memory_allocated")} for r in results]
    if args.out:
        rec.dump(args.out, args=vars(args))
        rec.note(f"wrote {args.out}")
    return rec.records


def sharded_rank(group, args, sampler, setup_s, note):
    """One pod rank of ``run_sharded`` (``launch/mesh.spawn`` calls it in
    the rank's process): the run's rounds on this rank's replica band.
    Rank 0 prints; every rank returns its counts."""
    dev = group.device
    sampler = sampler.to(dev)
    lead = group.rank == 0
    rec = obs_metrics.RunRecorder(
        transport=args.transport, log_format=args.log_format,
        printer=print if lead else (lambda *a, **kw: None))
    _train(args, dev, rec, group=group, sampler=sampler,
           data_setup_s=setup_s, note=note)
    return {"rank": group.rank, "device": str(dev),
            "records": rec.records if lead else None,
            "manifest": rec.manifest if lead else None,
            "launches": kops.launch_counts(),
            "traffic": dict(group.traffic),
            "timing": rec.manifest["timing"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None}


def _run_async_phase(args, dcfg, tcfg, loss_fn, sampler, params, ev, val,
                     rec):
    """Barrier-free run: the event loop replaces the round loop, as in
    the JAX trainer. One tick = the fastest worker's phase; ``--ticks 0``
    runs the ticks a barrier-paced run of ``--rounds`` rounds would take
    under the same scenario. ``rec`` receives every engine event as it
    happens and prints it. The recorder's ``manifest["timing"]["events"]``
    holds each phase's host seconds (``AsyncEngine.timing``)."""
    scenario = scenario_of(args) or faults.Scenario.uniform(args.k)
    samplers = tuple(
        (lambda i: lambda g, B, S: sampler.sample_shard(g, i, B, S))(i)
        for i in range(args.k))
    eng = async_diloco.AsyncEngine(
        loss_fn, samplers, dcfg, tcfg, scenario=scenario,
        total_steps=tcfg.total_steps, eval_fn=ev, eval_tokens=val,
        seed=args.seed)
    state = eng.init_state(params)
    ticks = args.ticks or scenario.sync_round_ticks(args.k) * args.rounds
    rec.attach_wire_plan([{"fragment": 0, "wire_bytes":
                           float(eng.wire_bytes()),
                           "wire_dtype": dcfg.outer_grad_dtype}])
    rec.note(f"async transport: lambda={dcfg.staleness_lambda} "
             f"k={args.k} {ticks} tick(s), {eng.wire_bytes()} B/apply")
    t0 = time.time()
    state, hist = eng.run(state, ticks=ticks, recorder=rec)
    rec.manifest["timing"]["events"] = eng.timing
    n_arr = sum(1 for r in hist if r["event"] == "arrival")
    rec.note(f"done in {time.time() - t0:.1f}s; {n_arr} applications "
             f"over {ticks} ticks; entropy floor = "
             f"{sampler.entropy_floor():.4f}")
    if args.out:
        rec.dump(args.out, args=vars(args))
        rec.note(f"wrote {args.out}")
    return rec.records


def make_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch "
                         "versions of the kernels")
    ap.add_argument("--arch", default="diloco_150m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--H", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--pretrain-steps", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eval-batch", type=int, default=64)
    ap.add_argument("--inner-lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--outer-opt", default="nesterov",
                    choices=["nesterov", "sgd", "sgdm", "adam"])
    ap.add_argument("--outer-lr", type=float, default=0.7)
    ap.add_argument("--outer-momentum", type=float, default=0.9)
    ap.add_argument("--regime", default="non_iid",
                    choices=["iid", "non_iid"])
    ap.add_argument("--drop-prob", type=float, default=0.0)
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--compute-schedule", default="constant_distributed",
                    choices=["constant_local", "constant_distributed",
                             "doubling", "halving", "ramp_up", "ramp_down"])
    ap.add_argument("--cosine-stats", action="store_true")
    ap.add_argument("--kernel-mode", default="auto",
                    choices=["auto", "kernel", "ref", "pallas", "interpret"],
                    help="optimizer kernels: auto = CUDA kernels on CUDA "
                         "tensors, plain PyTorch on the CPU; kernel = CUDA "
                         "kernels or an error; ref = the legacy tree maps")
    ap.add_argument("--rounds-per-call", type=int, default=0,
                    help="the JAX driver's scan chunk (0 = all rounds): "
                         "the port runs one round per call and evaluates "
                         "where the JAX driver does, on the --eval-every "
                         "rounds and the last round of every chunk")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="the JAX driver's per-round loop: the port "
                         "evaluates every round, as it does")
    ap.add_argument("--eval-every", type=int, default=1,
                    help="eval cadence in rounds (the last round is always "
                         "evaluated)")
    ap.add_argument("--guard-outer", action="store_true",
                    help="exclude replicas with non-finite outer deltas "
                         "from the outer reduce")
    ap.add_argument("--guard-clip", type=float, default=0.0,
                    help="with --guard-outer: clip each replica's "
                         "outer-delta norm to this multiple of the median")
    ap.add_argument("--prune-frac", type=float, default=0.0,
                    help="sign-prune this fraction of each outer-gradient "
                         "row before the reduce (paper Table 6)")
    ap.add_argument("--param-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="replica working params and AdamW moments")
    ap.add_argument("--master-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="per-replica master copy; wider than "
                         "--param-dtype keeps an f32 master (the mixed "
                         "policy)")
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--log-format", default="text", choices=["text", "json"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--stream-fragments", type=int, default=0,
                    help="streaming outer sync: number of parameter "
                         "fragments P (0 = classic synchronous outer step; "
                         "see core/streaming.py)")
    ap.add_argument("--stream-alpha", type=float, default=1.0,
                    help="streaming merge weight "
                         "θ_i <- α·θ_global + (1-α)·θ_i")
    ap.add_argument("--stream-tau", type=int, default=0,
                    help="inner steps between a fragment's snapshot and its "
                         "application (simulated in-flight collective)")
    ap.add_argument("--outer-grad-dtype", default="float32",
                    choices=["float32", "bfloat16", "int4"],
                    help="transport precision of outer gradients on the "
                         "wire")
    ap.add_argument("--error-feedback", action="store_true",
                    help="streaming: keep each replica's transport "
                         "quantization residual and add it to its next "
                         "delta")
    ap.add_argument("--transport", default="simulated",
                    choices=["simulated", "sharded", "async", "gossip"],
                    help="outer-sync backend: 'simulated' runs the rounds "
                         "(classic or streaming); 'sharded' the streaming "
                         "rounds on --pods ranks with real "
                         "torch.distributed collectives; 'async' is the "
                         "barrier-free event loop (core/async_diloco.py) "
                         "driven by the fault flags below; 'gossip' is not "
                         "ported yet (see ROADMAP.md)")
    ap.add_argument("--staleness-lambda", type=float, default=1.0,
                    help="async transport: an outer gradient tau outer "
                         "steps stale is applied at weight lambda^tau/k")
    ap.add_argument("--ticks", type=int, default=0,
                    help="async horizon in wall-clock ticks (1 tick = "
                         "fastest worker's phase; 0 = the ticks a "
                         "barrier-paced run of --rounds would take "
                         "under the same scenario)")
    ap.add_argument("--speeds", default="",
                    help="fault scenario: comma per-worker phase "
                         "duration in ticks (single value broadcasts; "
                         "e.g. 1,1,1,4 = one 4x straggler)")
    ap.add_argument("--link-latency", default="",
                    help="fault scenario: comma per-worker one-way "
                         "link latency in ticks added to every send")
    ap.add_argument("--latency-jitter", type=float, default=0.0,
                    help="fault scenario: lognormal sigma multiplying "
                         "each send's latency draw")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="fault scenario: resends after a dropped "
                         "attempt; a payload whose every attempt drops "
                         "is permanently lost")
    ap.add_argument("--retry-backoff", type=int, default=1,
                    help="fault scenario: ticks between a dropped "
                         "attempt and its resend")
    ap.add_argument("--preempt", action="append", default=[],
                    metavar="W:LEAVE[:REJOIN]",
                    help="fault scenario: worker W leaves at tick "
                         "LEAVE and rejoins at REJOIN (omit/0 = gone "
                         "for good); repeatable")
    ap.add_argument("--pods", type=int, default=0,
                    help="sharded transport: pod ranks, each holding k/pods "
                         "replicas (0 = the largest count >= 2 dividing k "
                         "that tiles the visible cards; on one card every "
                         "rank shares it over gloo)")
    ap.add_argument("--no-pack-wire", dest="pack_wire",
                    action="store_false", default=True,
                    help="sharded quantized transport: gather the "
                         "fake-quantized float payloads instead of the "
                         "packed int4 codes + scales (or bf16) wire")
    # ---- not ported: accepted so that they can be refused by name ----
    nyi = "not ported yet (see ROADMAP.md)"
    ap.add_argument("--gossip-pairing", default="butterfly", help=nyi)
    ap.add_argument("--gossip-mix", type=float, default=0.5, help=nyi)
    ap.add_argument("--restore", default="", help=nyi)
    ap.add_argument("--trace", default="", help=nyi)
    ap.add_argument("--checkpoint", default="", help=nyi)
    ap.add_argument("--checkpoint-dir", default="", help=nyi)
    ap.add_argument("--checkpoint-every", type=int, default=0, help=nyi)
    ap.add_argument("--resume", default="", help=nyi)
    ap.add_argument("--retain", type=int, default=3, help=nyi)
    ap.add_argument("--crash-at-round", type=int, default=-1, help=nyi)
    ap.add_argument("--crash-at-tick", type=int, default=-1, help=nyi)
    ap.add_argument("--nan-bomb", action="append", default=[], help=nyi)
    ap.add_argument("--guard", action="store_true", help=nyi)
    ap.add_argument("--guard-window", type=int, default=8, help=nyi)
    ap.add_argument("--guard-spike", type=float, default=4.0, help=nyi)
    ap.add_argument("--guard-rollbacks", type=int, default=2, help=nyi)
    ap.add_argument("--state-hash-out", default="", help=nyi)
    return ap


if __name__ == "__main__":
    run(make_parser().parse_args())
