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
  6. flash    the four flash-attention kernels against their plain
              versions (o and lse within 2e-5, dq, dk, dv within 5e-4,
              as atol = rtol) at diloco_400m's layer shape (B 8, H = G =
              12, S 1024, d 128, causal) and at GQA, sliding-window,
              bidirectional and non-block-aligned cases at d 64 and 128;
              then each kernel's time at the layer shape beside its plain
              version, one PyTorch library call (the yardstick, which the
              port never calls: ``scaled_dot_product_attention``) and the
              bound.
  7. train_400m  slice 2's path at full width: diloco_400m with
              ``use_pallas=True`` (the flash branch), k=2, H=4, 2 rounds,
              batch 8, seq 1024, through ``core.diloco.make_round`` and
              ``make_eval`` with ``arch.loss(..., cfg=...)`` as a user
              reaches it (the trainer's ``build`` for data and configs).
              The counters are set to 0 just before and read just after:
              per replica step 2·L ``fwd_lse`` (remat runs the forward
              twice), L ``bwd_dq`` and L ``bwd_dkv``, L ``fwd`` per eval,
              and the optimizer kernels' k·H·rounds·12 and rounds·12.
  8. profile_400m  one profiled inner step of that path, as phase 5.

Then the ``{"kernels": [...]}`` line (each kernel's launches from its own
path's run: phase 4 for the optimizer kernels, phase 7 for attention),
the card's line again, and the last line ``{"ok": true, "device":
{...}}``. Without a GPU, or run from a directory that holds nothing else
of the repository, it exits non-zero and prints no result.
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
FWD_TOL, BWD_TOL = 2e-5, 5e-4     # the JAX package's kernel tolerances
# B, H, G, S, d, causal, window: the 400m layer, then GQA, window,
# bidirectional and non-block-aligned cases at d 64 and 128
FLASH_LAYER = (BATCH, 12, 12, SEQ, 128, True, 0)
FLASH_CASES = [FLASH_LAYER] + [
    (b, h, g, s, d, c, w) for d in (64, 128)
    for b, h, g, s, c, w in ((2, 8, 2, 512, True, 0),
                             (1, 4, 4, 640, True, 256),
                             (2, 4, 2, 384, False, 0),
                             (2, 4, 2, 1000, True, 0))]
# H100 device-memory rates (NVIDIA data sheets), bytes/s, by card name
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
PEAK_F32 = 67e12       # f32 FLOP/s outside the tensor cores, H100 SXM
ADAMW_FLOPS, NESTEROV_FLOPS = 16, 6      # per element, kernels/csrc
ADAMW_BYTES, NESTEROV_BYTES = 28, 20     # 4 reads + 3 writes; 3 + 2
# device kernels of the profiled inner step, grouped by a name substring
PROFILE_GROUPS = (("flash", "flash_"), ("fused_adamw", "adamw_kernel"),
                  ("matmul", "gemm"),
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


def phase_profile(torch, dev, arch_name="diloco_150m", label="profile",
                  **cfg_changes):
    """Inner steps of one replica of ``arch_name`` (with ``cfg_changes``)
    at full width: the host syncs inside one step, then one step under the
    profiler (device time by kernel, and the device's busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import diloco
    from repro_torch.models.registry import get_arch
    from repro_torch.optim import adamw

    arch = get_arch(arch_name)
    cfg = arch.cfg.replace(**cfg_changes)
    params = arch.init(generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev, cfg=cfg)
    opt = adamw.init(params)
    step = diloco.make_inner_step(lambda p, b: arch.loss(p, b, cfg=cfg),
                                  TrainConfig(inner_lr=1e-3, warmup_steps=2))
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device=dev)
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
    say({"phase": label, "arch": arch_name, "cfg_changes": cfg_changes,
         "host_syncs_per_inner_step": len(syncs),
         "first_sync": syncs[:1], "wall_ms": wall_ms,
         "device_ms": device_ms if rows else "not measured",
         "device_busy_share": device_ms / wall_ms if rows else
         "not measured",
         "by_group_ms": groups,
         "top": [{"kernel": key[:100], "ms": ms, "calls": n}
                 for key, ms, n in rows[:12]]})
    del params, opt
    torch.cuda.empty_cache()


def phase_flash(torch, dev):
    """The four flash-attention kernels against their plain versions, then
    their times at diloco_400m's layer shape. Returns the kernels' rows."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import ref

    names = ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv")
    err = dict.fromkeys(names, 0.0)
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(B, Hh, G, S, d):
        return [torch.randn(shape, generator=gen, device=dev) for shape in
                ((B, Hh, S, d), (B, G, S, d), (B, G, S, d), (B, Hh, S, d))]

    def check(name, got, want, tol):
        """max |got - want|; fails unless within tol·(1 + |want|)."""
        diff = (got - want).abs()
        worst = float(diff.max())
        if not bool((diff <= tol + tol * want.abs()).all()):
            raise SystemExit(f"flash {name} differs from its plain version:"
                             f" max abs {worst} beyond {tol}·(1 + |want|)")
        err[name] = max(err[name], worst)
        return worst

    for case in FLASH_CASES:
        B, Hh, G, S, d, causal, window = case
        q, k, v, do = inputs(B, Hh, G, S, d)
        opts = dict(causal=causal, window=window)
        o_nolse = FK.flash_fwd(q, k, v, **opts)
        o, lse = FK.flash_fwd_lse(q, k, v, **opts)
        dq, dk, dv = FK.flash_bwd(q, k, v, o, lse, do, **opts)
        torch.cuda.synchronize()
        # the plain backward from the kernels' own residuals (o, lse)
        want_o, want_lse = ref.flash_fwd_lse(q, k, v, **opts)
        delta = (do * o).sum(-1)
        want_dq = ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts)
        want_dk, want_dv = ref.flash_bwd_dkv(q, k, v, lse, do, delta,
                                             **opts)
        say({"phase": "flash", "case": dict(zip(
            ("B", "H", "G", "S", "d", "causal", "window"), case)),
             "max_abs_err": {
                 "fwd": check("fwd", o_nolse, want_o, FWD_TOL),
                 "fwd_lse": max(check("fwd_lse", o, want_o, FWD_TOL),
                                check("fwd_lse", lse, want_lse, FWD_TOL)),
                 "bwd_dq": check("bwd_dq", dq, want_dq, BWD_TOL),
                 "bwd_dkv": max(check("bwd_dkv", dk, want_dk, BWD_TOL),
                                check("bwd_dkv", dv, want_dv, BWD_TOL))},
             "fwd_tol": FWD_TOL, "bwd_tol": BWD_TOL})
        del q, k, v, do, o_nolse, o, lse, dq, dk, dv, want_o, want_lse
        del delta, want_dq, want_dk, want_dv
    torch.cuda.empty_cache()

    # times at the 400m layer shape
    B, Hh, G, S, d, causal, window = FLASH_LAYER
    q, k, v, do = inputs(B, Hh, G, S, d)
    opts = dict(causal=causal, window=window)
    o, lse = FK.flash_fwd_lse(q, k, v, **opts)
    delta = (do * o).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    launch = dict(do=do, lse=lse, delta=delta, scale=d ** -0.5, q_offset=0,
                  **opts)
    kernel = {
        "fwd": lambda: FK.flash_fwd(q, k, v, **opts),
        "fwd_lse": lambda: FK.flash_fwd_lse(q, k, v, **opts),
        "bwd_dq": lambda: FK._launch("bwd_dq", q, k, v, out=dq, **launch),
        "bwd_dkv": lambda: FK._launch("bwd_dkv", q, k, v, out=None, dk=dk,
                                      dv=dv, **launch)}
    plain = {
        "fwd": lambda: ref.flash_fwd_lse(q, k, v, **opts)[0],
        "fwd_lse": lambda: ref.flash_fwd_lse(q, k, v, **opts),
        "bwd_dq": lambda: ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts),
        "bwd_dkv": lambda: ref.flash_bwd_dkv(q, k, v, lse, do, delta,
                                             **opts)}
    # the yardstick: PyTorch's fused attention on the same f32 inputs; it
    # computes dq, dk and dv in one backward call
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=causal)
    lib_fwd = time_ms(torch, lambda: sdpa(q, k, v, is_causal=causal))
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    library = {"fwd": lib_fwd, "fwd_lse": lib_fwd, "bwd_dq": lib_bwd,
               "bwd_dkv": lib_bwd}
    flash_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    both = {"kernels": lambda: torch.autograd.grad(FK.flash_attention(
                *flash_leaves, **opts), flash_leaves, do),
            "library": lambda: torch.autograd.grad(sdpa(
                *leaves, is_causal=causal), leaves, do)}
    fwd_bwd_ms = {n: time_ms(torch, fn) for n, fn in both.items()}

    # the bound: visible (query, key) pairs of this run's mask; flops per
    # pair and head: 2·d for each product a kernel computes (forward s and
    # p·v; dq s, dp and ds·k; dk/dv s, dp, pᵀ·dO and dsᵀ·q); bytes: each
    # input read once, each output written once
    pairs = int(ref.flash_visible(S, S, causal=causal, window=window,
                                  device=dev).sum()) * B * Hh
    nq, nkv, nrow = 4 * q.numel(), 4 * k.numel(), 4 * lse.numel()
    work = {"fwd": (4 * d * pairs, 2 * nq + 2 * nkv),
            "fwd_lse": (4 * d * pairs, 2 * nq + 2 * nkv + nrow),
            "bwd_dq": (6 * d * pairs, 3 * nq + 2 * nkv + 2 * nrow),
            "bwd_dkv": (8 * d * pairs, 2 * nq + 4 * nkv + 2 * nrow)}
    bw = bandwidth(torch.cuda.get_device_name(0))
    tpu = {"fwd": "src/repro/kernels/flash_attention.py:218",
           "fwd_lse": "src/repro/kernels/flash_attention.py:293",
           "bwd_dq": "src/repro/kernels/flash_attention.py:360",
           "bwd_dkv": "src/repro/kernels/flash_attention.py:380"}
    rows = []
    for n in names:
        flops, nbytes = work[n]
        by_ops, by_bytes = flops / PEAK_F32, nbytes / bw
        t = {"ms": time_ms(torch, kernel[n]),
             "plain_ms": time_ms(torch, plain[n])}
        rows.append({"name": f"flash_{n}", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                     "replaces": tpu[n], "launches": None,
                     "max_abs_err": err[n], **t,
                     "bound_ms": max(by_ops, by_bytes) * 1e3,
                     "bound_by": "operations" if by_ops >= by_bytes
                     else "bytes", "library_ms": library[n]})
        say({"phase": "flash", "kernel": n, "shape": list(FLASH_LAYER),
             "flops": flops, "bytes": nbytes, **t,
             "bound_ms": rows[-1]["bound_ms"],
             "bound_by": rows[-1]["bound_by"], "library_ms": library[n],
             "kernel_TFLOPs": flops / t["ms"] / 1e9})
    say({"phase": "flash", "fwd_plus_bwd_ms": fwd_bwd_ms,
         "shape": list(FLASH_LAYER)})
    del q, k, v, do, o, lse, delta, dq, dk, dv, leaves, out, flash_leaves
    torch.cuda.empty_cache()
    return rows


def phase_train_400m(torch, dev):
    """Slice 2's path at full width: diloco_400m with use_pallas=True
    through ``make_round``/``make_eval``. Returns {kernel: launches}."""
    from repro_torch import tree
    from repro_torch.core import diloco
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import fused_adamw as FA
    from repro_torch.kernels import outer_nesterov as ON
    from repro_torch.launch import train

    argv = ["--full", "--arch", "diloco_400m", "--k", str(K), "--H", str(H),
            "--rounds", str(ROUNDS), "--batch", str(BATCH), "--seq",
            str(SEQ)]
    args = train.make_parser().parse_args(argv)
    t0 = time.perf_counter()
    arch, cfg, dcfg, tcfg, sampler = train.build(args, dev)
    data_setup_s = time.perf_counter() - t0
    # no trainer flag sets use_pallas: a user reaches it through the loss
    cfg = cfg.replace(use_pallas=True)
    loss_fn = lambda p, b: arch.loss(p, b, cfg=cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = arch.init(generator=gen, device=dev, cfg=cfg)
    n_params = sum(t.numel() for t in tree.leaves(params))
    state = diloco.init_state(params, dcfg)
    del params
    rnd = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                            total_steps=tcfg.total_steps, batch_size=BATCH,
                            seq_len=SEQ)
    ev = diloco.make_eval(loss_fn)
    val = sampler.sample_validation(
        torch.Generator(device=dev).manual_seed(10_000), BATCH, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    FK.launches.update(dict.fromkeys(FK.launches, 0))
    FA.launches = ON.launches = 0
    rounds = []
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        state, m = rnd(state, gen)
        rounds.append({"inner_loss": float(m["inner_loss"]),
                       "val_loss": float(ev(state.global_params, val)),
                       **{n: m[n] for n in ("sample_s", "inner_s",
                                            "outer_s")}})
    wall_s = time.perf_counter() - t0
    L, steps = cfg.n_layers, K * H * ROUNDS
    launches = {**{f"flash_{n}": c for n, c in FK.launches.items()},
                "fused_adamw": FA.launches, "outer_nesterov": ON.launches}
    want = {"flash_fwd": ROUNDS * L, "flash_fwd_lse": 2 * L * steps,
            "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
            "fused_adamw": steps * N_LEAVES,
            "outer_nesterov": ROUNDS * N_LEAVES}
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    if not all(math.isfinite(r[n]) for r in rounds
               for n in ("inner_loss", "val_loss")):
        raise SystemExit(f"bad round records: {rounds}")
    # model FLOPs per token as in phase 4 (no recompute, full S·S)
    n_matmul = n_params - cfg.vocab_size * cfg.d_model
    flops_tok = 6 * n_matmul + 12 * L * SEQ * cfg.n_heads \
        * cfg.resolved_head_dim
    tok_s = K * H * BATCH * SEQ / rounds[-1]["inner_s"]
    say({"phase": "train_400m", "argv": argv, "use_pallas": True,
         "params": n_params, "launches": launches, "rounds": rounds,
         "data_setup_s": data_setup_s, "tokens_per_s": tok_s,
         "model_flops_per_token": flops_tok,
         "mfu_vs_f32_peak": tok_s * flops_tok / PEAK_F32,
         "inner_step_ms": rounds[-1]["inner_s"] * 1e3 / (K * H),
         "outer_step_ms": rounds[-1]["outer_s"] * 1e3, "wall_s": wall_s,
         "max_memory_allocated_GB":
             torch.cuda.max_memory_allocated(dev) / 1e9})
    del state, sampler, val
    torch.cuda.empty_cache()
    return launches


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
    rows += phase_flash(torch, dev)
    # each kernel's launches from its own path's run
    launches.update({n: c for n, c in phase_train_400m(torch, dev).items()
                     if n.startswith("flash_")})
    phase_profile(torch, dev, "diloco_400m", "profile_400m", use_pallas=True)
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
