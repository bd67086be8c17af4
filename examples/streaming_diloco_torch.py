"""Streaming DiLoCo on the PyTorch + CUDA port: fragment-scheduled outer
sync with overlap and quantized transport (the JAX
``examples/streaming_diloco.py``).

Trains the same reduced model twice — classic synchronous DiLoCo (every
H steps a full-model outer step) and streaming DiLoCo (P fragments
synced on a staggered schedule, applies delayed τ inner steps to model
an in-flight collective, outer gradients sent as int4) — and prints the
loss trajectories next to the wire bytes each run puts on the wire. The
bytes are counted, not modelled: one sharded round of the streaming
config run on meta tensors by a ``CountingGroup``
(``launch/comm_analysis.py``: the pod group's calls, counted where they
are made, nothing computed or sent), beside the static byte model.

``--sharded`` also runs the streaming config on the REAL sharded
transport (``core/pod_collectives.py``): one process per replica, each a
pod rank (gloo on the CPU or between ranks that share a card, NCCL with a
card per rank), every fragment reduced by a collective; its measured
column is the ranks' ``PodGroup.traffic``.

  PYTHONPATH=src python examples/streaming_diloco_torch.py [--sharded]

The same knobs are on the training CLI:

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch diloco_150m --k 4 --H 20 --rounds 10 \\
      --stream-fragments 4 --stream-alpha 0.5 --stream-tau 2 \\
      --outer-grad-dtype int4 [--transport sharded --pods 4]
"""
import argparse

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import DiLoCoConfig, TrainConfig
from repro_torch.core import diloco, fragments, streaming
from repro_torch.data.sharding import make_regime
from repro_torch.kernels.ops import transport_bytes
from repro_torch.launch import comm_analysis, mesh, op_cost
from repro_torch.launch.train import resolve_device
from repro_torch.models.registry import get_smoke_arch


def main():
    # spawned pod ranks import this module: the run stays under main
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--H", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--fragments", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--wire-dtype", default="int4",
                    choices=["float32", "bfloat16", "int4"],
                    help="transport precision of outer gradients")
    ap.add_argument("--sharded", action="store_true",
                    help="also run the streaming config on the real sharded "
                         "transport, one pod rank per replica")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    device = resolve_device(args.device)

    arch = get_smoke_arch("diloco_150m")
    loss_fn = lambda p, b: arch.loss(p, b)
    sampler = make_regime("non_iid", k=args.k, vocab_size=arch.cfg.vocab_size,
                          device=device)
    total = args.rounds * args.H
    tcfg = TrainConfig(inner_lr=3e-3, warmup_steps=20, total_steps=total,
                       batch_size=args.batch, seq_len=args.seq)
    params = arch.init(generator=torch.Generator(device=device).manual_seed(0),
                       device=device)
    n_params = sum(t.numel() for t in tree.leaves(params))
    val = sampler.sample_validation(
        torch.Generator(device=device).manual_seed(42), 64, args.seq)

    stream_kw = dict(k=args.k, H=args.H, streaming_fragments=args.fragments,
                     stream_alpha=args.alpha, stream_tau=args.tau,
                     outer_grad_dtype=args.wire_dtype)
    configs = {"sync": DiLoCoConfig(k=args.k, H=args.H),
               "stream": DiLoCoConfig(**stream_kw)}
    histories = {}
    for name, dcfg in configs.items():
        run = diloco.make_run(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                              rounds_per_call=args.rounds, total_steps=total,
                              batch_size=args.batch, seq_len=args.seq,
                              eval_tokens=val, eval_every=1)
        state = (streaming.init_state(params, dcfg) if dcfg.streaming_fragments
                 else diloco.init_state(params, dcfg))
        state, ms = run(state, torch.Generator(device=device).manual_seed(7))
        histories[name] = ms["val_loss"].cpu().numpy()

    print(f"\nmodel: {arch.cfg.name} ({n_params / 1e6:.2f}M params), "
          f"k={args.k} H={args.H} rounds={args.rounds}")
    print(f"streaming: P={args.fragments} alpha={args.alpha} tau={args.tau} "
          f"wire={args.wire_dtype}\n")
    print(f"{'round':>5s} {'sync val':>10s} {'stream val':>11s}")
    for t in range(args.rounds):
        print(f"{t + 1:5d} {histories['sync'][t]:10.4f} "
              f"{histories['stream'][t]:11.4f}")

    part = fragments.partition_params(params, args.fragments)
    sync_peak = transport_bytes(n_params, "float32")
    # int4's f32 scales charged per contiguous leaf region
    stream_peak = max(sum(transport_bytes(e, args.wire_dtype) for e in regs)
                      for regs in part.region_sizes)
    print("\nwire profile (per replica):")
    print(f"  sync   : 1 x {sync_peak / 1e6:8.2f} MB per round (full model, "
          "f32, blocking barrier)")
    print(f"  stream : {args.fragments} x <={stream_peak / 1e6:8.2f} MB per "
          f"round ({args.wire_dtype}, each with {args.tau} inner steps of "
          "overlap)")
    print(f"  peak bytes-per-sync reduction: {sync_peak / stream_peak:.1f}x")

    # one sharded round of the streaming config, its collectives counted on
    # meta tensors (rank 0 of k pod ranks, one replica each)
    sdcfg = DiLoCoConfig(transport="sharded", **stream_kw)
    group = comm_analysis.CountingGroup(0, args.k)
    meta = arch.init(generator=None, device="meta")
    rnd = diloco.make_round(
        loss_fn, lambda g, n, s: torch.zeros((args.k, n, s),
                                             dtype=torch.int64,
                                             device="meta"),
        sdcfg, tcfg, total_steps=total, batch_size=args.batch,
        seq_len=args.seq, group=group)
    with op_cost.counting():
        rnd(streaming.init_state(meta, sdcfg, group=group), None)
    counted = group.traffic["wire_bytes"]

    measured = None
    if args.sharded:
        gen = torch.Generator(device=device).manual_seed(7)
        toks = [sampler.sample_all_shards(gen, args.H * args.batch,
                                          args.seq).cpu()
                for _ in range(args.rounds)]
        ones = np.ones((args.k,), np.float32)
        ranks = mesh.spawn("repro_torch.launch.pod_rounds:rounds",
                           mesh.make_pod_layout(args.k, device.type),
                           arch.cfg, sdcfg, tcfg, toks,
                           [(ones, ones, ones)] * args.rounds,
                           tree.map(lambda t: t.detach().cpu().clone(),
                                    params))
        measured = ranks[0]["traffic"]["wire_bytes"] / args.rounds
        losses = [m["inner_loss"] for m in ranks[0]["metrics"]]
        print(f"\nsharded transport on {args.k} pod ranks: inner loss by "
              f"round {np.round(losses, 4).tolist()}")

    packed = lambda dt: sum(transport_bytes(e, dt, packed=dt != "float32")
                            for regs in part.region_sizes for e in regs)
    print(f"\nwire bytes per replica per round (k={args.k}):")
    print(f"  {'wire dtype':>10s} {'model':>12s} {'packed model':>14s} "
          f"{'counted':>10s} {'measured':>10s}")
    for dt in ("float32", "bfloat16", "int4"):
        mine = dt == args.wire_dtype
        model = sum(transport_bytes(e, dt) for regs in part.region_sizes
                    for e in regs)
        c = f"{counted:10.0f}" if mine else f"{'-':>10s}"
        m = f"{measured:10.0f}" if mine and measured is not None \
            else f"{'-':>10s}"
        print(f"  {dt:>10s} {model:12.0f} {packed(dt):14.0f} {c} {m}")
    print("  (counted: the collectives a sharded round makes, at their call "
          "sites on meta tensors;\n   measured: PodGroup.traffic of the real "
          "sharded run. counted == packed model == measured.)")


if __name__ == "__main__":
    main()
