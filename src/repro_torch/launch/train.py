"""DiLoCo training driver (CLI), the synchronous path of the JAX
``launch/train.py``: an optional single-worker pretraining phase, then
T rounds of (H inner AdamW steps × k replicas + one outer Nesterov
step), with the paper's data regimes, communication drops, adaptive
compute schedules and outer optimizers.

It takes the JAX driver's flags and prints its console and ``--out``
JSON lines. Two flags differ: ``--device`` (default ``cuda``; a run on
the CPU is asked for with ``--device cpu``) and ``--kernel-mode``
(``auto`` by default: the CUDA kernels on CUDA tensors, their plain
PyTorch versions on the CPU). With ``--prune-frac`` each round's record
also carries ``prune_density``, the share of the outer-gradient entries
kept. ``--stream-fragments P`` runs
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
one line per event. ``--transport gossip`` runs NoLoCo-style pairwise
partial averaging (``core/gossip.py``: ``--gossip-pairing``,
``--gossip-mix``, ``--stream-fragments`` as its fragment schedule,
``--outer-grad-dtype`` float32 or bfloat16); its records carry
``gossip_edges``, ``gossip_spread``, ``gossip_frag`` and
``exchange_frac``. On the round transports the same fault flags are
projected onto the rounds' drop and active masks. ``--trace FILE`` writes
a tick-domain Chrome trace of the run on every transport (``obs/trace.py``,
the JAX trace's lanes and events); on the sharded transport with deferred
gathers its fragment lanes carry the issue→consume offsets measured on the
run's own gathers (``pod_collectives.OverlapProbe``), where the JAX
trainer reads them from the lowered HLO.

The rounds run in chunks of ``--rounds-per-call`` through
``core.diloco.make_run`` (all rounds in one chunk by default), whose
metrics reach the host once per chunk (``RunRecorder.ingest_chunk``);
``--legacy-loop`` runs one ``make_round`` call and one eval per round,
with the same numbers. At the chunk boundaries sit the resilience hooks
(``resilience/``), as in the JAX driver: durable snapshots
(``--checkpoint-dir``, ``--checkpoint-every``, ``--retain``; ``--resume
auto|N`` picks one up, ``--state-hash-out`` writes the final state's
digest), the scripted SIGKILL (``--crash-at-round``), NaN-poisoned outer
gradients (``--nan-bomb W:ROUND``) and the anomaly guard (``--guard``:
on a non-finite or spiking loss, roll back to the last good snapshot and
replay with the in-graph guard armed). Chunks are cut at the snapshot
cadence and at the crash round. On the sharded transport rank 0 writes
each snapshot from the gathered state, at host placement, so that a
snapshot resumes under any ``--pods`` that bands k; rank 0 judges the
guard for every rank, and the crash kills every rank and then the
trainer. The async transport takes a snapshot every
``--checkpoint-every`` events, ``--crash-at-tick``, and the full engine
state through ``--checkpoint``/``--restore``.

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
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --k 2 --H 2 --rounds 6 --batch 2 --seq 32 --rounds-per-call 2 \\
      --checkpoint-dir /tmp/ckpt --checkpoint-every 2 --crash-at-round 3
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --k 2 --H 2 --rounds 6 --batch 2 --seq 32 --rounds-per-call 2 \\
      --checkpoint-dir /tmp/ckpt --checkpoint-every 2 --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --transport sharded --pods 4 --stream-fragments 2 \\
      --outer-grad-dtype int4 --error-feedback --k 4 --H 2 --rounds 4 \\
      --batch 2 --seq 32 --checkpoint-dir /tmp/ckpt --resume 2
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --transport gossip --gossip-pairing random --stream-fragments 2 \\
      --outer-grad-dtype bfloat16 --k 4 --H 2 --rounds 4 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time

import numpy as np
import torch

from .. import resilience, tree
from ..checkpoint import checkpoint as ckpt
from ..configs.base import DiLoCoConfig, TrainConfig
from ..core import (async_diloco, diloco, faults, gossip,
                    pod_collectives, schedules, streaming)
from ..data.sharding import make_regime, shard_weights
from ..kernels import ops as kops
from ..models.registry import get_arch, get_smoke_arch
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..optim import adamw, precision
from . import mesh

# what the measured overlap's ``dots_between`` counts (the trace's otherData)
DOTS_BETWEEN = ("forward matmuls (models.layers.matmuls: weight and attention "
                "products, per replica, evals included) that pod rank 0 "
                "issued between the gather's issue and its first wait; the "
                "backward's are not counted")


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
    injections ride the scenario too: the round-domain flags convert
    through the barrier pacing T (one round = T ticks), so that
    ``Scenario.crash_round`` and ``nan_masks`` project them back.
    """
    used = (args.speeds or args.link_latency
            or args.latency_jitter > 0 or args.max_retries > 0
            or args.preempt or args.transport == "async"
            or args.crash_at_tick >= 0 or args.crash_at_round >= 0
            or args.nan_bomb)
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
    scen = faults.Scenario(
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
    T = scen.sync_round_ticks(k)
    crash_tick = args.crash_at_tick
    if args.crash_at_round >= 0:
        crash_tick = args.crash_at_round * T
    bombs = []
    for spec in args.nan_bomb:
        parts = spec.split(":")
        if len(parts) != 2:
            raise SystemExit(f"--nan-bomb wants WORKER:ROUND, got {spec!r}")
        bombs.append((int(parts[0]), int(parts[1]) * T))
    if crash_tick >= 0 or bombs:
        scen = dataclasses.replace(scen, crash_tick=crash_tick,
                                   nan_bombs=tuple(bombs))
    return scen


def chunk_len(t: int, rounds: int, rounds_per_call: int, *,
              checkpoint_every: int = 0, crash_round: int = -1) -> int:
    """Rounds of the chunk that starts after round ``t`` (0-based): at
    most ``--rounds-per-call`` (0: all), cut so that it ends on the
    snapshot cadence and on the crash round, as the JAX driver cuts it."""
    rpc = max(1, min(rounds_per_call or rounds, rounds))
    n = min(rpc, rounds - t)
    if checkpoint_every:
        n = min(n, checkpoint_every - t % checkpoint_every)
    if 0 <= crash_round and t <= crash_round:
        n = min(n, crash_round + 1 - t)
    return n


def eval_rounds(rounds: int, eval_every: int, *, legacy_loop: bool,
                rounds_per_call: int, checkpoint_every: int = 0,
                crash_round: int = -1) -> list:
    """Per round (0-based), whether the trainer reports a val loss for it,
    as the JAX trainer does: every round under ``--legacy-loop`` (one eval
    per dispatch); else, over the chunks of ``chunk_len``, the rounds g =
    t + 1 with g % eval_every == 0 and the last round of every chunk
    (``make_run``'s rule)."""
    if legacy_loop:
        return [True] * rounds
    out, t = [], 0
    while t < rounds:
        n = chunk_len(t, rounds, rounds_per_call,
                      checkpoint_every=checkpoint_every,
                      crash_round=crash_round)
        out += [(t + i + 1) % eval_every == 0 or i == n - 1
                for i in range(n)]
        t += n
    return out


def check_args(args):
    """The JAX trainer's validation of its flags, with its messages; and
    the refusal of the JAX package's TPU kernel modes."""
    if args.kernel_mode in ("pallas", "interpret"):
        raise SystemExit(f"--kernel-mode {args.kernel_mode} names TPU "
                         "(Pallas) machinery; the port's modes are "
                         "auto|kernel|ref")
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
    if args.transport in ("async", "gossip"):
        # barrier-free transports: streaming mechanics that have no
        # meaning off the fragment-round path are rejected, not ignored
        # (the JAX trainer's check; gossip takes --stream-fragments as its
        # partial-averaging schedule)
        bad = [flag for flag, on in (
            ("--stream-alpha", args.stream_alpha != 1.0),
            ("--stream-tau", args.stream_tau != 0),
            ("--no-pack-wire", not args.pack_wire),
            ("--pods", args.pods != 0),
            ("--legacy-loop", args.legacy_loop),
            ("--cosine-stats", args.cosine_stats)) if on]
        if args.transport == "async" and args.stream_fragments:
            bad.insert(0, "--stream-fragments")
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
    if args.restore and args.transport != "async":
        raise SystemExit("--restore resumes a full async engine state; "
                         "round transports resume from --checkpoint-dir "
                         "snapshots (--resume auto) instead")
    # ---- resilience flags (the JAX trainer's validation) ----
    if not args.checkpoint_dir:
        need_dir = [flag for flag, on in (
            ("--resume", bool(args.resume)),
            ("--checkpoint-every", args.checkpoint_every > 0)) if on]
        if need_dir:
            raise SystemExit(f"{', '.join(need_dir)} require(s) "
                             "--checkpoint-dir")
    if args.legacy_loop and (args.checkpoint_dir or args.guard
                             or args.crash_at_round >= 0
                             or args.nan_bomb):
        raise SystemExit("--checkpoint-dir/--guard/--crash-at-round/"
                         "--nan-bomb need the chunked driver's chunk "
                         "boundaries; drop --legacy-loop")
    if args.crash_at_tick >= 0 and args.crash_at_round >= 0:
        raise SystemExit("--crash-at-tick and --crash-at-round are "
                         "exclusive (tick = async domain, round = "
                         "barrier domain)")
    if args.crash_at_tick >= 0 and args.transport != "async":
        raise SystemExit("--crash-at-tick addresses the async event "
                         "timeline; round transports use "
                         "--crash-at-round")
    if args.nan_bomb and (args.transport != "simulated"
                          or args.stream_fragments):
        raise SystemExit("--nan-bomb injects into the classic outer "
                         "reduce (--transport simulated, no "
                         "--stream-fragments)")
    if args.guard_clip > 0 and not args.guard_outer:
        raise SystemExit("--guard-clip scales deltas inside the in-graph "
                         "guard; add --guard-outer")
    if args.resume and args.resume != "auto" \
            and not args.resume.isdigit():
        raise SystemExit(f"--resume wants 'auto' or a snapshot step, "
                         f"got {args.resume!r}")


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
                        staleness_lambda=args.staleness_lambda,
                        gossip_pairing=args.gossip_pairing,
                        gossip_mix=args.gossip_mix)
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
    check_args(args)
    device = resolve_device(args.device)
    if args.transport == "sharded":
        return run_sharded(args, device, recorder, sampler=sampler)
    return _train(args, device, recorder,
                  sampler=None if sampler is None else sampler.to(device))


def _check_snapshot_rng(path: str, example_key: np.ndarray, step: int):
    """Refuse a snapshot whose generator state cannot seed this run: one
    the JAX package wrote (a (2,) uint32 ``jax.random`` key) or one of
    another device's generator."""
    with np.load(path) as data:
        key = data["rng//key"] if "rng//key" in data.files else None
        if key is None or key.dtype != np.uint8:
            raise SystemExit(
                f"--resume {step}: {path} was written by the JAX package "
                "(its rng/key is a jax.random key, not a torch.Generator "
                "state): the port resumes only its own snapshots. Its "
                "state subtree still loads through "
                "repro_torch.checkpoint.checkpoint.restore")
        if key.shape != example_key.shape:
            raise SystemExit(
                f"--resume {step}: {path} holds the state of a generator "
                f"of {key.size} bytes, this run's has "
                f"{example_key.size}: resume on the device that wrote it")


def pick_resume(args, mgr, device):
    """The snapshot ``--resume`` names (``auto``: the newest that
    verifies), verified once, here: (its step, {"step", "verify_s"}), or
    (None, None) when ``auto`` finds none. Refuses a snapshot that fails
    verification, one of another replica count (``k`` in its metadata:
    a resume, also under another ``--pods``, keeps k) and one whose
    generator state cannot seed this run."""
    step = (mgr.latest_good() if args.resume == "auto"
            else int(args.resume))
    if step is None:
        return None, None
    t0 = time.perf_counter()
    ok = mgr.verify(step)
    timing = {"step": step, "verify_s": time.perf_counter() - t0}
    if not ok:
        raise SystemExit(f"--resume {step}: snapshot fails integrity "
                         "verification")
    path = mgr.path_of(step)
    if os.path.exists(path + ".meta.json"):
        k_snap = ckpt.load_metadata(path).get("k")
        if k_snap is not None and int(k_snap) != args.k:
            raise SystemExit(
                f"--resume {step}: the snapshot holds k={k_snap} replicas "
                f"and this run has --k {args.k}: a resume keeps the "
                "replica count (--pods may change, k may not)")
    _check_snapshot_rng(path, torch.Generator(device=device).get_state()
                        .numpy(), step)
    return step, timing


def _train(args, device, recorder=None, *, group=None, sampler=None,
           data_setup_s=None, note=None, resume=None):
    """The run on ``device``; on the sharded transport, one pod rank's
    part of it (``group``; the sampler, its set-up seconds and the
    ``resume`` pick come from the parent). Only the lead process (rank 0)
    evaluates, judges the guard, and writes snapshots and outputs: a
    snapshot gathers every rank's replica band onto rank 0
    (``pod_collectives.gather_stream_state``) and is written at host
    placement, so that a resume under any ``--pods`` that bands k loads
    the full state and bands it for its own ranks."""
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
    timing = {"device": str(device), "data_setup_s": data_setup_s}

    # ---- resilience: durable snapshots and the resume picker ----
    mgr = (resilience.CheckpointManager(args.checkpoint_dir,
                                        retain=args.retain)
           if args.checkpoint_dir else None)
    resume_step = None
    if args.resume and mgr is not None and args.transport != "async":
        resume_step, resume_timing = (pick_resume(args, mgr, device)
                                      if resume is None else resume)
        if resume_step is None:
            rec.note("resume: no verified snapshot, starting fresh")
        else:
            timing["resume"] = resume_timing

    # ---- pretraining phase (paper: 24k steps before DiLoCo) ----
    # a resumed run skips it: the snapshot's state and generator carry it
    if args.pretrain_steps and resume_step is None:
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
    rec.manifest["timing"] = timing
    if dcfg.transport == "async":
        return _run_async_phase(args, dcfg, tcfg, loss_fn, sampler, params,
                                ev, val, rec)
    frag_wire = None            # gossip: per-fragment exchange bytes
    full_example = None         # sharded: a full state's shapes (meta)
    if dcfg.transport == "gossip":
        state = gossip.init_state(params, dcfg)
        frag_wire = gossip.frag_bytes(params, dcfg)
        round_wire = None
        plan = [{"fragment": i, "wire_bytes": float(b),
                 "wire_dtype": dcfg.outer_grad_dtype}
                for i, b in enumerate(frag_wire)]
        note = (f"gossip transport: {dcfg.gossip_pairing} pairing, "
                f"mix={dcfg.gossip_mix}, "
                f"P={max(1, dcfg.streaming_fragments)} fragment(s), "
                f"{max(frag_wire)} B/exchange")
    elif dcfg.streaming_fragments:
        state = streaming.init_state(params, dcfg, group=group)
        plan = streaming.sync_plan(params, dcfg)
        round_wire = sum(row["wire_bytes"] for row in plan)
        if group is not None:
            full_example = streaming.init_state(tree.map(
                lambda p: torch.empty_like(p, device="meta"), params), dcfg)
    else:
        state = diloco.init_state(params, dcfg)
        round_wire = diloco.outer_wire_bytes(params, dcfg)
        plan = [{"fragment": 0, "send_step": args.H, "apply_step": args.H,
                 "wire_bytes": float(round_wire),
                 "wire_dtype": dcfg.outer_grad_dtype}]
    del params
    rec.attach_wire_plan(plan)
    if note:
        rec.note(note)

    def load_snapshot(step):
        """Snapshot ``step`` restored into the live state (in place) and
        the generator; on the sharded transport the full state is loaded
        on the host and this rank's band of it placed on the device (the
        old state is dropped first). Returns (state, rounds done)."""
        nonlocal state
        t0, band = time.perf_counter(), None
        if full_example is None:
            example = resilience.wrap(state, gen, 0)
            _check_snapshot_rng(mgr.path_of(step), example["rng"]["key"],
                                step)
            st, key, done = resilience.unwrap(mgr.load(step, example,
                                                       in_place=True))
        else:
            state = None
            full, key, done = resilience.unwrap(ckpt.reshape_like(
                mgr.load_tree(step), resilience.wrap(full_example, gen, 0)))
            band = time.perf_counter()
            st = pod_collectives.shard_stream_state(full, group)
            del full
        gen.set_state(key)
        diloco._sync(device)
        end = time.perf_counter()
        load = {"step": step, "load_s": (band or end) - t0}
        if band is not None:
            load["band_s"] = end - band
        timing.setdefault("loads", []).append(load)
        return st, done

    def gathered(st):
        """The full state (rank 0; None on the other ranks): every rank
        calls it on the sharded transport."""
        return st if group is None else \
            pod_collectives.gather_stream_state(st, group)

    def save_snapshot(t):
        """The durable snapshot after round ``t``: written by rank 0 from
        the gathered state; every rank then waits for it, so that none
        runs ahead into the next snapshot. The ranks' generators must
        agree (each draws all k shards and keeps its band)."""
        diloco._sync(device)
        t_s = time.perf_counter()
        full = gathered(state)
        entry = {"step": t}
        if group is not None:
            diloco._sync(device)
            entry["gather_s"] = time.perf_counter() - t_s
            if not group.agree(bytes(gen.get_state().numpy())):
                raise RuntimeError(
                    f"snapshot {t}: the pod ranks' token generators "
                    "disagree; each rank must draw every shard's batches")
        if lead:
            t_w = time.perf_counter()
            stats = mgr.save(t, resilience.wrap(full, gen, t),
                             metadata={"transport": args.transport,
                                       "k": args.k, "H": args.H,
                                       "rounds_done": t})
            stats.pop("path")
            entry.update(stats, save_s=time.perf_counter() - (
                t_s if group is None else t_w))
            timing.setdefault("snapshots", []).append(entry)
        del full
        if group is not None:
            group.barrier()

    rounds_done = 0
    if resume_step is not None:
        state, rounds_done = load_snapshot(resume_step)
        rec.note(f"resumed snapshot {resume_step}: "
                 f"{rounds_done} round(s) done")

    # masks of every round from one stream, indexed by round (a resumed
    # run takes its rows from rounds_done on)
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
    drops, acts = np.asarray(drops), np.asarray(acts)
    weights = shard_weights(sampler, args.weighted)
    nan_masks = None
    if scen is not None and scen.nan_bombs:
        nan_masks = scen.nan_masks(args.k, args.rounds)
        rec.note(f"nan bombs armed: {int(nan_masks.sum())} "
                 "(worker, round) cell(s)")
    crash_round = scen.crash_round(args.k) if scen is not None else -1
    gossip_rounds = []         # gossip: each round's exchange edges
    trace_plan = plan if dcfg.streaming_fragments \
        and dcfg.transport != "gossip" else ()
    if args.trace and group is not None \
            and any(row.get("deferred") for row in trace_plan):
        group.probe = pod_collectives.OverlapProbe()
    guard = None
    if args.guard and lead:
        # one judge for the run: on the sharded transport only rank 0
        # evaluates, and it hands its verdict to the other ranks
        guard = resilience.AnomalyGuard(
            resilience.GuardConfig(window=args.guard_window,
                                   spike=args.guard_spike,
                                   max_rollbacks=args.guard_rollbacks),
            recorder=rec)
    timing["rounds"] = []

    def emit_round(t, m, i=None, evaled=True):
        """Round t's record from metrics ``m``: scalars (the per-round
        loop) or (R,) arrays read at index ``i`` (a chunk). ``evaled``
        False marks a round the eval cadence skipped."""
        pick = float if i is None else (lambda x: float(x[i]))
        extras = {kk: pick(m[kk]) for kk in (
            "inner_loss_last", "drop_frac", "gossip_spread", "gossip_frag",
            "exchange_frac", "prune_density", "guard_rejected",
            "guard_clipped", "stream_peak_sync_bytes",
            "stream_round_sync_bytes") if kk in m}
        if args.cosine_stats:
            extras["cos_mean"] = pick(m["cos_mean"])
            extras["cos_std"] = pick(m["cos_std"])
        wire, edges = round_wire, None
        if frag_wire is not None:       # gossip: the round's fragment
            wire = frag_wire[t % len(frag_wire)]
            edges = gossip.pairing_edges(args.k, t, args.gossip_pairing,
                                         seed=args.seed)
            gossip_rounds.append({"round": t, "fragment": t % len(frag_wire),
                                  "edges": [list(e) for e in edges]})
        rec.round(round=t + 1, rounds=args.rounds,
                  inner_steps=args.pretrain_steps + (t + 1) * args.H,
                  inner_loss=pick(m["inner_loss"]),
                  val_loss=pick(m["val_loss"]) if "val_loss" in m
                  else float("nan"),
                  outer_gnorm=pick(m["outer_gnorm"]),
                  active=int(acts[t].sum()),
                  dropped=int(args.k - drops[t].sum()),
                  wire_bytes=wire, gossip_edges=edges, extras=extras,
                  evaled=evaled)
        timing["rounds"].append({kk: pick(m[kk]) for kk in (
            "sample_s", "inner_s", "outer_s", "wait_s") if kk in m})

    t0 = time.time()
    if args.legacy_loop:
        # one round per call and one eval per round, on the host
        rnd = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg,
                                tcfg, total_steps=tcfg.total_steps,
                                compute_cosine=args.cosine_stats,
                                batch_size=args.batch, seq_len=args.seq,
                                group=group)
        for t in range(args.rounds):
            state, m = rnd(state, gen, drops[t], acts[t], weights)
            m["val_loss"] = evaluate(state.global_params)
            emit_round(t, m)
    else:
        # the chunked driver: chunks of make_run rounds, the metrics
        # copied to the host once per chunk; the snapshots, the scripted
        # crash and the guard live at the chunk boundaries
        ckpt_every = args.checkpoint_every if mgr is not None else 0
        guarded = False       # after a guard rollback the replay runs
        #                       with the in-graph guard armed
        t = rounds_done
        while t < args.rounds:
            n = chunk_len(t, args.rounds, args.rounds_per_call,
                          checkpoint_every=ckpt_every,
                          crash_round=crash_round)
            run_n = diloco.make_run(
                loss_fn, sampler.sample_all_shards,
                dataclasses.replace(dcfg, guard_outer=True) if guarded
                else dcfg, tcfg, rounds_per_call=n,
                total_steps=tcfg.total_steps,
                compute_cosine=args.cosine_stats, batch_size=args.batch,
                seq_len=args.seq, eval_tokens=val if lead else None,
                eval_every=args.eval_every, group=group,
                nan_bombs=nan_masks)
            state, ms = run_n(state, gen, drops[t:t + n], acts[t:t + n],
                              weights, round_offset=t)
            ms = rec.ingest_chunk(ms)
            evaled = [(t + i + 1) % args.eval_every == 0 or i == n - 1
                      for i in range(n)]
            for i in range(n):
                emit_round(t + i, ms, i, evaled=evaled[i])
            t += n
            # (1) the scripted kill, BEFORE this boundary's snapshot: the
            # resume replays the crashed rounds from the last snapshot.
            # Every rank reaches this boundary, waits for the others (no
            # rank dies inside a collective) and kills itself.
            if 0 <= crash_round < t:
                rec.note(f"crash: SIGKILL at round boundary {t}")
                if group is not None:
                    group.barrier()
                os.kill(os.getpid(), signal.SIGKILL)
            # (2) the guard judges the chunk from the metrics on the host;
            # on an anomaly, roll back to the last good snapshot and
            # replay with the in-graph guard armed. On the sharded
            # transport rank 0 judges and every rank takes its decision.
            if args.guard:
                back, bad = -1, None
                if guard is not None:
                    losses = [ms["val_loss"][i]
                              if evaled[i] and "val_loss" in ms
                              else ms["inner_loss"][i] for i in range(n)]
                    bad = guard.observe_chunk(t - n, losses)
                    if bad and mgr is not None and guard.can_rollback():
                        good = mgr.latest_good()
                        if good is not None and good < t:
                            back = good
                if group is not None:
                    back = group.decide(back)
                if back >= 0:
                    state, t = load_snapshot(back)
                    if guard is not None:
                        guard.rolled_back(to_round=back,
                                          skip_round=bad[0]["round"])
                    guarded = True
                    rec.note(f"guard: restored snapshot {back}; "
                             "replaying with the in-graph guard armed")
                    continue
            # (3) the durable snapshot at the cadence
            if ckpt_every and (t % ckpt_every == 0 or t == args.rounds):
                save_snapshot(t)

    floor = sampler.entropy_floor()
    rec.note(f"done in {time.time() - t0:.1f}s; "
             f"entropy floor = {floor:.4f} (ppl {np.exp(floor):.2f})")
    if args.trace and lead:
        other = {"manifest": rec.manifest}
        overlap = None
        if group is not None and group.probe is not None:
            overlap = group.probe.overlap(tau=dcfg.stream_tau)
            other["overlap"] = dict(
                overlap, measured_on="pod rank 0's round collectives",
                dots_between_counts=DOTS_BETWEEN)
            rec.note(
                f"overlap (measured): {overlap['n_deferred']} deferred "
                f"wires, min {overlap['min_steps_between']} steps / "
                f"{overlap['min_dots_between']} dots issue->consume "
                f"(tau={dcfg.stream_tau})")
        obs_trace.round_trace(
            transport=args.transport, k=args.k, rounds=args.rounds,
            H=args.H, scenario=scen, drops=drops, acts=acts,
            history=rec.round_records(), plan=trace_plan,
            wire_bytes=round_wire, gossip_rounds=gossip_rounds,
            overlap=overlap).write(args.trace, other_data=other)
        rec.note(f"trace: {args.trace}")
    if args.out and group is None:
        rec.dump(args.out, args=vars(args))
        rec.note(f"wrote {args.out}")
    final = gathered(state) if args.checkpoint or args.state_hash_out \
        else None
    if args.checkpoint and lead:
        ckpt.save(args.checkpoint,
                  {"params": final.global_params,
                   "outer_buf": final.outer_state.buf},
                  metadata={"rounds": args.rounds, "k": args.k,
                            "H": args.H})
        rec.note(f"checkpoint: {args.checkpoint}")
    if args.state_hash_out and lead:
        rrecs = rec.round_records()
        vals = [r["val_loss"] for r in rrecs if r["val_loss"] is not None]
        ckpt.atomic_write_json(args.state_hash_out, {
            "state_sha256": resilience.tree_sha256(final),
            "leaf_sha256": resilience.leaf_hashes(final),
            "final_val_loss": vals[-1] if vals else None,
            "final_inner_loss": rrecs[-1]["inner_loss"] if rrecs else None,
            "resumed_from_step": (-1 if resume_step is None
                                  else int(resume_step)),
            "rounds_done": args.rounds,
            "ingest_calls": rec.ingest_calls,
            "rollbacks": 0 if guard is None else guard.rollbacks_used},
            indent=2)
        rec.note(f"state hash: {args.state_hash_out}")
    return rec.records


def run_sharded(args, device, recorder=None, *, sampler=None):
    """``--transport sharded``: lay ``--pods`` ranks over the visible
    cards (or the CPU), build the Markov tables once, here, and hand them
    to the ranks (shared memory on the CPU, CUDA IPC on a card; a rank on
    another card copies them), then run ``sharded_rank`` on every rank
    (``launch/mesh.spawn``). Rank 0 prints and records; its records are
    returned and land in ``recorder``, whose ``manifest["ranks"]`` holds
    every rank's device, kernel launches, collective traffic, timing and
    peak device memory. A failure in any rank fails the run.

    ``--resume`` is picked and verified here, once (``pick_resume``); the
    ranks load the full snapshot and band it for this run's pod count.
    Under ``--crash-at-round`` every rank kills itself at the boundary;
    once ``mesh.spawn`` has reaped them (and removed its temporary
    directory) this process dies by SIGKILL too, as a crash on the other
    transports does."""
    n_dev = mesh.visible_devices(device.type)
    pods = args.pods or mesh.default_pods(args.k, n_dev)
    if pods < 2:
        raise SystemExit(
            "--transport sharded needs >= 2 pods, but no pod count >= 2 "
            f"divides k={args.k} and tiles the {n_dev} visible device(s) "
            "— a 1-pod group would run zero real cross-pod collectives")
    pod_collectives.check_bands(args.k, pods)
    resume = None
    if args.resume and args.checkpoint_dir:
        resume = pick_resume(args, resilience.CheckpointManager(
            args.checkpoint_dir, retain=args.retain), device)
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
    try:
        results = mesh.spawn("repro_torch.launch.train:sharded_rank",
                             layout, args, sampler, setup_s, note, resume)
    except mesh.RanksKilled:
        if args.crash_at_round < 0:
            raise
        # the scripted crash: every rank died at the boundary
        os.kill(os.getpid(), signal.SIGKILL)
    if device.type == "cuda":
        torch.cuda.ipc_collect()       # the ranks' handles on the tables
    # rank 0 printed the run's lines; this recorder takes its records
    rec = recorder if recorder is not None else obs_metrics.RunRecorder(
        transport=args.transport, log_format=args.log_format)
    rec.records[:] = results[0]["records"]
    rec.wire_bytes_total = sum(float(r.get("wire_bytes") or 0.0)
                               for r in rec.records)
    rec.manifest.update(results[0]["manifest"])
    rec.manifest["ranks"] = [{kk: r[kk] for kk in (
        "rank", "device", "launches", "traffic", "timing",
        "max_memory_allocated")} for r in results]
    if args.out:
        rec.dump(args.out, args=vars(args))
        rec.note(f"wrote {args.out}")
    return rec.records


def sharded_rank(group, args, sampler, setup_s, note, resume=None):
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
           data_setup_s=setup_s, note=note, resume=resume)
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
    holds each phase's host seconds (``AsyncEngine.timing``).

    With ``--checkpoint-dir`` and ``--checkpoint-every N`` the event loop
    runs in slices of N events and takes a snapshot of the whole engine
    state (``state_to_tree``) after each, keyed by the events done;
    ``--resume`` restarts from one, ``--restore`` from a ``--checkpoint``
    file. Each phase draws its tokens from a generator seeded from (seed,
    the timeline's uid), so a restored run replays the same suffix."""
    scenario = scenario_of(args) or faults.Scenario.uniform(args.k)
    samplers = tuple(
        (lambda i: lambda g, B, S: sampler.sample_shard(g, i, B, S))(i)
        for i in range(args.k))
    eng = async_diloco.AsyncEngine(
        loss_fn, samplers, dcfg, tcfg, scenario=scenario,
        total_steps=tcfg.total_steps, eval_fn=ev, eval_tokens=val,
        seed=args.seed)
    device = tree.leaves(params)[0].device
    mgr = (resilience.CheckpointManager(args.checkpoint_dir,
                                        retain=args.retain)
           if args.checkpoint_dir else None)
    resumed_from = -1
    state = None
    if args.resume and mgr is not None:
        step = (mgr.latest_good() if args.resume == "auto"
                else int(args.resume))
        if step is None:
            rec.note("resume: no verified snapshot, starting fresh")
        else:
            state = async_diloco.state_from_tree(
                mgr.load_tree(step, device=device), params)
            resumed_from = step
            rec.note(f"resumed async snapshot {step}: "
                     f"version={state.version} "
                     f"events_done={state.events_done}")
    elif args.restore:
        state = async_diloco.state_from_tree(
            ckpt.restore_tree(args.restore, device=device), params)
        rec.note(f"restored async state: version={state.version} "
                 f"events_done={state.events_done}")
    if state is None:
        state = eng.init_state(params)
    ticks = args.ticks or scenario.sync_round_ticks(args.k) * args.rounds
    eng._bind(state)
    rec.attach_wire_plan([{"fragment": 0, "wire_bytes":
                           float(eng.wire_bytes()),
                           "wire_dtype": dcfg.outer_grad_dtype}])
    rec.note(f"async transport: lambda={dcfg.staleness_lambda} "
             f"k={args.k} {ticks} tick(s), {eng.wire_bytes()} B/apply")
    on_crash = None
    if scenario.crash_tick >= 0:
        def on_crash(_state):
            rec.note(f"crash: SIGKILL at tick {scenario.crash_tick}")
            os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.time()
    if mgr is not None and args.checkpoint_every > 0:
        # the event loop in slices, a durable snapshot after each: the
        # engine's events_done cursor is the resume point
        hist = []
        while True:
            state, h = eng.run(state, ticks=ticks,
                               max_events=args.checkpoint_every,
                               recorder=rec, on_crash=on_crash)
            hist.extend(h)
            mgr.save(state.events_done, async_diloco.state_to_tree(state),
                     metadata={"transport": "async", "k": args.k,
                               "events_done": state.events_done})
            if len(h) < args.checkpoint_every:
                break
    else:
        state, hist = eng.run(state, ticks=ticks, recorder=rec,
                              on_crash=on_crash)
    rec.manifest["timing"]["events"] = eng.timing
    n_arr = sum(1 for r in hist if r["event"] == "arrival")
    rec.note(f"done in {time.time() - t0:.1f}s; {n_arr} applications "
             f"over {ticks} ticks; entropy floor = "
             f"{sampler.entropy_floor():.4f}")
    if args.trace:
        obs_trace.async_trace(scenario, args.k, ticks, history=hist,
                              wire_bytes=eng.wire_bytes()).write(
            args.trace, other_data={"manifest": rec.manifest})
        rec.note(f"trace: {args.trace}")
    if args.out:
        rec.dump(args.out, args=vars(args))
        rec.note(f"wrote {args.out}")
    if args.checkpoint:
        # the whole engine state: a later --restore replays the same
        # event suffix
        ckpt.save(args.checkpoint, async_diloco.state_to_tree(state),
                  metadata={"transport": "async", "k": args.k,
                            "H": args.H, "ticks": ticks,
                            "events_done": state.events_done})
        rec.note(f"checkpoint: {args.checkpoint}")
    if args.state_hash_out:
        vals = [r["val_loss"] for r in hist if "val_loss" in r]
        ckpt.atomic_write_json(args.state_hash_out, {
            "state_sha256": resilience.tree_sha256(
                async_diloco.state_to_tree(state)),
            "final_val_loss": vals[-1] if vals else None,
            "resumed_from_step": resumed_from,
            "events_done": int(state.events_done),
            "ingest_calls": rec.ingest_calls,
            "rollbacks": 0}, indent=2)
        rec.note(f"state hash: {args.state_hash_out}")
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
                    help="rounds of one make_run chunk (0 = all rounds); "
                         "the metrics reach the host once per chunk")
    ap.add_argument("--legacy-loop", action="store_true",
                    help="one make_round call and one eval per round "
                         "instead of the chunked driver")
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
                         "driven by the fault flags below; 'gossip' is "
                         "NoLoCo-style pairwise partial averaging with no "
                         "global collective (core/gossip.py)")
    ap.add_argument("--staleness-lambda", type=float, default=1.0,
                    help="async transport: an outer gradient tau outer "
                         "steps stale is applied at weight lambda^tau/k")
    ap.add_argument("--gossip-pairing", default="butterfly",
                    choices=["butterfly", "random"],
                    help="gossip partner schedule: butterfly (hypercube "
                         "dims, k a power of 2, provably exact mixing "
                         "in log2 k rounds) or a fresh random perfect "
                         "matching per round")
    ap.add_argument("--gossip-mix", type=float, default=0.5,
                    help="gossip adoption rate: g_i <- g_i + "
                         "mix*(g_partner - g_i) on the scheduled "
                         "fragment")
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
    ap.add_argument("--restore", default="",
                    help="async transport: resume from a full engine state "
                         "written by --checkpoint (replays the same event "
                         "suffix)")
    ap.add_argument("--checkpoint", default="",
                    help="write the final global params and outer momentum "
                         "(async: the whole engine state) to this npz")
    # ---- resilience (src/repro_torch/resilience/) ----
    ap.add_argument("--checkpoint-dir", default="",
                    help="durable snapshot directory (atomic npz + sha256 "
                         "manifest per snapshot, retention, resume picker)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot cadence: every N rounds (round "
                         "transports) / every N events (async)")
    ap.add_argument("--resume", default="",
                    help="'auto' resumes from the newest snapshot in "
                         "--checkpoint-dir that verifies (falling back past "
                         "corrupt ones); a number resumes that step")
    ap.add_argument("--retain", type=int, default=3,
                    help="snapshots kept in --checkpoint-dir (oldest "
                         "deleted first)")
    ap.add_argument("--crash-at-round", type=int, default=-1,
                    help="fault injection: SIGKILL this process at the "
                         "chunk boundary right after the given round, "
                         "before that boundary's snapshot")
    ap.add_argument("--crash-at-tick", type=int, default=-1,
                    help="fault injection: a crash event in the async "
                         "timeline at this tick (SIGKILL when reached)")
    ap.add_argument("--nan-bomb", action="append", default=[],
                    metavar="W:ROUND",
                    help="fault injection: poison worker W's outer gradient "
                         "to NaN in the given round (repeatable; classic "
                         "simulated transport)")
    ap.add_argument("--guard", action="store_true",
                    help="host-side anomaly guard at chunk boundaries: on a "
                         "non-finite or spiking loss, roll back to the last "
                         "good snapshot and replay with --guard-outer armed")
    ap.add_argument("--guard-window", type=int, default=8,
                    help="guard rolling-statistics window (rounds)")
    ap.add_argument("--guard-spike", type=float, default=4.0,
                    help="guard spike threshold in rolling std devs")
    ap.add_argument("--guard-rollbacks", type=int, default=2,
                    help="guard rollbacks allowed per run")
    ap.add_argument("--state-hash-out", default="",
                    help="write a JSON with the final state's sha256, the "
                         "final losses and the resume provenance")
    ap.add_argument("--trace", default="",
                    help="write a tick-domain Chrome trace-event JSON of the "
                         "run (workers, fragments, transfers, faults; on "
                         "the sharded transport the issue->consume offsets "
                         "measured on the deferred gathers): open it in "
                         "Perfetto or chrome://tracing")
    return ap


if __name__ == "__main__":
    run(make_parser().parse_args())
