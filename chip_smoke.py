#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU, and the quickest proof that the port still starts there.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. device   the card (``nvidia-smi`` name and power limit), the torch and
              CUDA versions, the kernels built from ``kernels/csrc`` (one
              nvcc per source, in parallel); TF32 is switched off.
  2. kernels  each CUDA kernel against its plain PyTorch version at the
              main path's leaf shapes (2 ulp pass; bitwise is expected),
              then the time of one update of diloco_150m's whole 12-leaf
              tree: kernel, plain version, one PyTorch library call (the
              yardstick; the port never calls it) and the bound.
  3. smoke    a k=2, H=2 round of the diloco_150m smoke config on the card
              (kernels) against the same round on the CPU (plain versions):
              every state leaf within atol 1e-5, rtol 1e-4.
  4. train    the main path at full width: ``repro_torch.launch.train
              --full --arch diloco_150m --k 2 --H 4 --rounds 2 --batch 8
              --seq 1024 --eval-batch 8``. The launch counters are set to 0
              just before and read just after: exactly k·H·rounds·12
              fused_adamw and rounds·12 outer_nesterov launches.
  5. profile  inner steps of one replica at full width: the host syncs
              inside a step (``torch.cuda`` sync debug mode), then one
              step under ``torch.profiler``: device time by kernel group
              and the top kernels.

Then the ``{"kernels": [...]}`` line, the card's line again, and the last
line ``{"ok": true, "device": {...}}``. Without a GPU, or run from a
directory that holds nothing else of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

K, H, ROUNDS, BATCH, SEQ = 2, 4, 2, 8, 1024
N_LEAVES = 12
# H100 device-memory rates (NVIDIA data sheets), bytes/s, by card name
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
PEAK_F32 = 67e12       # f32 FLOP/s outside the tensor cores, H100 SXM
ADAMW_FLOPS, NESTEROV_FLOPS = 16, 6      # per element, kernels/csrc
ADAMW_BYTES, NESTEROV_BYTES = 28, 20     # 4 reads + 3 writes; 3 + 2
# device kernels of the profiled inner step, grouped by a name substring
PROFILE_GROUPS = (("fused_adamw", "adamw_kernel"), ("matmul", "gemm"),
                  ("softmax", "softmax"), ("reduction", "reduce"),
                  ("elementwise", "elementwise"),
                  ("elementwise", "vectorized"), ("copy", "copy"),
                  ("index", "index"))


def say(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bandwidth(name: str) -> float:
    for key, rate in BANDWIDTH:
        if key in name:
            return rate
    raise SystemExit(f"no memory rate known for {name!r}")


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median ms of ``fn`` over ``reps`` runs, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def ulps(torch, a, b) -> int:
    d = a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(
        torch.int64)
    return int(d.abs().max()) if a.numel() else 0


# ---------------------------------------------------------------------------

def phase_device(torch):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    for name, log in build.build_log.items():
        print(f"[ptxas {name}] {log['ptxas']}", flush=True)
    say({"phase": "device", "card": card_line(),
         "kind": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "build_s": build_s,
         "built": sorted(built), "tf32": False})


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the main path's leaf
    shapes, then the whole-tree timings. Returns the kernels' rows."""
    from repro_torch import tree
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import outer_nesterov as ON
    from repro_torch.kernels import ref
    from repro_torch.models.registry import get_arch

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda shape: torch.randn(shape, generator=gen, device=dev)
    hp = dict(lr=3e-4, c1=0.19, c2=0.0975, b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1)
    err = {"fused_adamw": [0.0, 0], "outer_nesterov": [0.0, 0]}
    shapes = {"stack0.mlp.w_up": (12, 896, 3584),
              "embed.table": (32000, 896), "ln_f.scale": (896,),
              "ragged": (1_000_003,)}
    for leaf, shape in shapes.items():
        for offset in (0, 1):      # 1: unaligned pointers, scalar path
            n = math.prod(shape)
            p, g, m, v = (rnd(n + offset)[offset:].view(shape)
                          for _ in range(4))
            v = v.abs()
            pairs = {
                "fused_adamw": (FA.fused_adamw(p, g, m, v, **hp),
                                ref.fused_adamw(p, g, m, v, **hp)),
                "outer_nesterov": (ON.outer_nesterov(p, g, m, lr=0.7),
                                   ref.outer_nesterov(p, g, m, lr=0.7))}
            torch.cuda.synchronize()
            for name, (got, want) in pairs.items():
                for a, b in zip(got, want):
                    e = err[name]
                    e[0] = max(e[0], float((a - b).abs().max()))
                    e[1] = max(e[1], ulps(torch, a, b))
            say({"phase": "kernels", "leaf": leaf, "shape": list(shape),
                 "offset": offset,
                 **{f"{k}_max_abs_err": v[0] for k, v in err.items()},
                 **{f"{k}_max_ulps": v[1] for k, v in err.items()}})
            del p, g, m, v, pairs
    for name, (e, u) in err.items():
        if u > 2:
            raise SystemExit(f"{name}: kernel differs from its plain version "
                             f"by {u} ulp (max abs {e})")

    # one update of the whole diloco_150m tree (12 leaves, N elements)
    shapes = [tuple(t.shape) for t in tree.leaves(
        get_arch("diloco_150m").init(generator=None, device="meta"))]
    n = sum(math.prod(s) for s in shapes)
    # trees as the port keeps them: dicts, leaves in sorted-key order
    mk = lambda: {f"{i:02d}": rnd(s) for i, s in enumerate(shapes)}
    P, G, M, V = mk(), mk(), mk(), {k: t.abs() for k, t in mk().items()}
    lP, lG, lM, lV = (list(t.values()) for t in (P, G, M, V))
    bw = bandwidth(torch.cuda.get_device_name(0))

    def bound(bytes_per, flops_per):
        by_bytes, by_ops = n * bytes_per / bw, n * flops_per / PEAK_F32
        return (max(by_bytes, by_ops) * 1e3,
                "bytes" if by_bytes >= by_ops else "operations")

    steps = [torch.full((), 5.0, device=dev) for _ in shapes]
    adamw_ms = {
        "ms": time_ms(torch, lambda: ops.adamw_update_tree(
            P, G, M, V, lr=3e-4, count=5, mode="kernel")),
        "plain_ms": time_ms(torch, lambda: [ref.fused_adamw(
            p, g, m, v, **hp) for p, g, m, v in zip(lP, lG, lM, lV)]),
        "library_ms": time_ms(torch, lambda: torch._fused_adamw_(
            lP, lG, lM, lV, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False))}
    nest_ms = {
        "ms": time_ms(torch, lambda: ops.nesterov_update_tree(
            P, G, M, lr=0.7, momentum=0.9, mode="kernel")),
        "plain_ms": time_ms(torch, lambda: [ref.outer_nesterov(
            p, g, b, lr=0.7) for p, g, b in zip(lP, lG, lM)]),
        "library_ms": time_ms(torch, lambda: torch._fused_sgd_(
            lP, lG, lM, weight_decay=0.0, momentum=0.9, lr=0.7, dampening=0.0,
            nesterov=True, maximize=False, is_first_step=False))}
    rows = []
    for name, t, bpe, fpe, src, tpu in (
            ("fused_adamw", adamw_ms, ADAMW_BYTES, ADAMW_FLOPS,
             "src/repro_torch/kernels/csrc/fused_adamw.cu",
             "src/repro/kernels/fused_adamw.py:96"),
            ("outer_nesterov", nest_ms, NESTEROV_BYTES, NESTEROV_FLOPS,
             "src/repro_torch/kernels/csrc/outer_nesterov.cu",
             "src/repro/kernels/outer_nesterov.py:31")):
        b_ms, b_by = bound(bpe, fpe)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": None,
                     "max_abs_err": err[name][0], **t, "bound_ms": b_ms,
                     "bound_by": b_by})
        say({"phase": "kernels", "kernel": name, "tree_elements": n,
             "leaves": len(shapes), "bytes": n * bpe, "kernel_ms": t["ms"],
             **t,
             "bound_ms": b_ms, "bound_by": b_by,
             "kernel_GBps": n * bpe / t["ms"] / 1e6})
    del P, G, M, V, lP, lG, lM, lV
    torch.cuda.empty_cache()
    return rows


def phase_smoke(torch, dev):
    """A k=2, H=2 round of the smoke config on the card and on the CPU."""
    import numpy as np
    from repro_torch import convert, tree
    from repro_torch.configs.base import DiLoCoConfig, TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_smoke_arch

    k, h, b, s = 2, 2, 2, 64
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (k, h * b, s),
                         generator=gen)

    def run(device):
        dcfg = DiLoCoConfig(k=k, H=h)
        tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=8)
        rnd = diloco.make_round(lambda p, bt: arch.loss(p, bt),
                                lambda g, bb, ss: toks.to(device), dcfg,
                                tcfg, batch_size=b, seq_len=s)
        st = diloco.init_state(tree.map(lambda t: t.to(device), params),
                               dcfg)
        st, m = rnd(st, None)
        return convert.state_to_numpy(st), float(m["inner_loss"])

    got, loss_gpu = run(dev)
    want, loss_cpu = run(torch.device("cpu"))
    worst, worst_path = 0.0, ""
    for (path, a), (_, w) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
        d = float(np.max(np.abs(np.asarray(a, np.float64) - w),
                         initial=0.0))
        if d > worst:
            worst, worst_path = d, path
    say({"phase": "smoke", "arch": arch.cfg.name, "k": k, "H": h,
         "leaves_compared": len(tree.paths(got)), "max_abs_diff": worst,
         "worst_leaf": worst_path, "inner_loss_cuda": loss_gpu,
         "inner_loss_cpu": loss_cpu, "rtol": 1e-4, "atol": 1e-5})


def phase_train(torch, dev):
    """The main path at full width, through the trainer's entry point.
    Returns {kernel name: launches}."""
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import outer_nesterov as ON
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.models.registry import get_arch
    from repro_torch.obs.metrics import RunRecorder

    argv = ["--full", "--arch", "diloco_150m", "--k", str(K), "--H", str(H),
            "--rounds", str(ROUNDS), "--batch", str(BATCH), "--seq",
            str(SEQ), "--eval-batch", "8"]
    args = train.make_parser().parse_args(argv)
    assert args.device == "cuda" and args.kernel_mode == "auto"
    rec = RunRecorder(log_format="text")
    torch.cuda.reset_peak_memory_stats(dev)
    FA.launches = ON.launches = 0
    t0 = time.perf_counter()
    records = train.run(args, recorder=rec)
    wall_s = time.perf_counter() - t0
    launches = {"fused_adamw": FA.launches, "outer_nesterov": ON.launches}
    want = {"fused_adamw": K * H * ROUNDS * N_LEAVES,
            "outer_nesterov": ROUNDS * N_LEAVES}
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    losses = [(r["inner_loss"], r["val_loss"]) for r in records]
    if len(records) != ROUNDS or not all(
            math.isfinite(x) for pair in losses for x in pair):
        raise SystemExit(f"bad round records: {losses}")
    timing = rec.manifest["timing"]
    last = timing["rounds"][-1]
    # model FLOPs per token (PaLM's count, no recompute): 6 per matmul
    # weight (all but the embedding gather) + 12·L·S·H·hd of attention
    cfg = get_arch(args.arch).cfg
    n_matmul = sum(math.prod(t.shape) for t in tree.leaves(get_arch(
        args.arch).init(generator=None, device="meta"))) \
        - cfg.vocab_size * cfg.d_model
    flops_tok = 6 * n_matmul + 12 * cfg.n_layers * SEQ * cfg.n_heads \
        * cfg.resolved_head_dim
    tok_s = K * H * BATCH * SEQ / last["inner_s"]
    say({"phase": "train", "argv": argv, "launches": launches,
         "losses": losses, "data_setup_s": timing["data_setup_s"],
         "rounds": timing["rounds"],
         "tokens_per_s": tok_s, "model_flops_per_token": flops_tok,
         "mfu_vs_f32_peak": tok_s * flops_tok / PEAK_F32,
         "inner_step_ms": last["inner_s"] * 1e3 / (K * H),
         "outer_step_ms": last["outer_s"] * 1e3,
         "sample_ms": last["sample_s"] * 1e3, "wall_s": wall_s,
         "max_memory_allocated_GB":
             torch.cuda.max_memory_allocated(dev) / 1e9})
    return launches


def phase_profile(torch, dev):
    """Inner steps of one diloco_150m replica at full width: the host
    syncs inside one step, then one step under the profiler (device time
    by kernel, and the device's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_arch
    from repro_torch.optim import adamw

    arch = get_arch("diloco_150m")
    params = arch.init(generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    opt = adamw.init(params)
    step = diloco.make_inner_step(lambda p, b: arch.loss(p, b),
                                  TrainConfig(inner_lr=1e-3, warmup_steps=2))
    toks = torch.randint(0, arch.cfg.vocab_size, (BATCH, SEQ), device=dev)
    params, opt, _ = step(params, opt, {"tokens": toks}, 0)   # warm-up
    torch.cuda.synchronize()
    # host syncs inside one step: each drains the device's queue, and the
    # device then idles while the host issues the next kernels
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        params, opt, _ = step(params, opt, {"tokens": toks}, 1)
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, {"tokens": toks}, 2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own kernel events only: an operator's row (aten::mm)
    # repeats the time of the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {}
    for key, ms, _ in rows:
        g = next((name for name, pat in PROFILE_GROUPS if pat in key),
                 "other")
        groups[g] = groups.get(g, 0.0) + ms
    say({"phase": "profile", "host_syncs_per_inner_step": len(syncs),
         "first_sync": syncs[:1], "wall_ms": wall_ms,
         "device_ms": device_ms if rows else "not measured",
         "device_busy_share": device_ms / wall_ms if rows else
         "not measured",
         "by_group_ms": groups,
         "top": [{"kernel": key[:100], "ms": ms, "calls": n}
                 for key, ms, n in rows[:12]]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    phase_device(torch)
    rows = phase_kernels(torch, dev)
    phase_smoke(torch, dev)
    launches = phase_train(torch, dev)
    phase_profile(torch, dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    say({"kernels": rows})
    print(card_line(), flush=True)
    say({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
