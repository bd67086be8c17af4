"""End-to-end driver on the PyTorch + CUDA port: the paper's full
protocol at reduced scale (the JAX ``examples/e2e_pretrain_diloco.py``).

Phase 1 — single-worker pretraining (paper: 24k steps).
Phase 2 — DiLoCo with k=8 replicas on non-i.i.d. shards (paper: 64k
          steps, H=500), with checkpoints and the communication each
          scheme would ship.

``--full`` uses the paper's real 150M config; the default is its reduced
variant. Runs on the GPU by default; ``--device cpu`` runs the plain
PyTorch versions.

  PYTHONPATH=src python examples/e2e_pretrain_diloco_torch.py [--full]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import DiLoCoConfig, TrainConfig
from repro_torch.core import diloco
from repro_torch.data.sharding import make_regime
from repro_torch.launch.train import resolve_device
from repro_torch.models.registry import get_arch, get_smoke_arch
from repro_torch.optim import adamw

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda")
ap.add_argument("--full", action="store_true",
                help="use the real 150M config")
ap.add_argument("--k", type=int, default=8)
ap.add_argument("--H", type=int, default=20)
ap.add_argument("--rounds", type=int, default=10)
ap.add_argument("--pretrain", type=int, default=100)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--out", default=None,
                help="checkpoint directory (default: a new temporary one)")
args = ap.parse_args()
device = resolve_device(args.device)

arch = (get_arch if args.full else get_smoke_arch)("diloco_150m")
loss_fn = lambda p, b: arch.loss(p, b)
sampler = make_regime("non_iid", k=args.k, vocab_size=arch.cfg.vocab_size,
                      device=device)
total = args.pretrain + args.rounds * args.H
tcfg = TrainConfig(inner_lr=3e-3, warmup_steps=30, total_steps=total,
                   batch_size=args.batch, seq_len=args.seq)
evaluate = diloco.make_eval(loss_fn)
gen = torch.Generator(device=device).manual_seed(1)
val = sampler.sample_validation(
    torch.Generator(device=device).manual_seed(42), 64, args.seq)

# ---- phase 1: pretrain ----
t0 = time.time()
params = arch.init(generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
n_params = sum(t.numel() for t in tree.leaves(params))
print(f"model: {arch.cfg.name} ({n_params / 1e6:.1f}M params)")
step = diloco.make_single_worker_step(loss_fn, tcfg)
opt = adamw.init(params)
for i in range(args.pretrain):
    batch = {"tokens": sampler.sample_validation(gen, args.batch, args.seq)}
    params, opt, m = step(params, opt, batch, i)
ppl0 = np.exp(float(evaluate(params, val)))
print(f"[pretrain] {args.pretrain} steps, val ppl {ppl0:.1f} "
      f"({time.time() - t0:.0f}s)")
if args.out is None:
    args.out = tempfile.mkdtemp(prefix="diloco_e2e_torch_")
os.makedirs(args.out, exist_ok=True)
ckpt.save(os.path.join(args.out, "pretrained.npz"), {"params": params},
          metadata={"steps": args.pretrain})

# ---- phase 2: DiLoCo ----
dcfg = DiLoCoConfig(k=args.k, H=args.H)
state = diloco.init_state(params, dcfg)._replace(
    inner_steps_done=args.pretrain)
round_fn = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                             total_steps=total, batch_size=args.batch,
                             seq_len=args.seq)
for t in range(args.rounds):
    state, m = round_fn(state, gen)
    ppl = np.exp(float(evaluate(state.global_params, val)))
    print(f"[diloco round {t + 1}/{args.rounds}] inner "
          f"{float(m['inner_loss']):.3f} val ppl {ppl:.1f}")
ckpt.save(os.path.join(args.out, "diloco_final.npz"),
          {"params": state.global_params},
          metadata={"rounds": args.rounds, "k": args.k, "H": args.H})

# ---- communication accounting (the paper's headline) ----
pbytes = diloco.outer_wire_bytes(params, dcfg)
sync_bytes = pbytes * args.rounds * args.H     # DDP: grads every step
diloco_bytes = pbytes * args.rounds            # DiLoCo: once per round
print(f"\ncheckpoints -> {args.out}")
print(f"communication per replica: DDP-equivalent "
      f"{sync_bytes / 1e6:.0f} MB vs DiLoCo {diloco_bytes / 1e6:.0f} MB "
      f"({args.H}x reduction)")
