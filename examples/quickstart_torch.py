"""Quickstart for the PyTorch + CUDA port: the DiLoCo run of
``examples/quickstart.py`` through ``repro_torch``'s chunked round driver
(``core.diloco.make_run``).

Trains a small transformer with 4 DiLoCo replicas on non-i.i.d. shards,
4 rounds per ``make_run`` call, the val loss evaluated at the end of each
call. Runs on the GPU by default (the CUDA kernels); ``--device cpu``
runs the kernels' plain PyTorch versions instead (about a minute).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import DiLoCoConfig, TrainConfig
from repro_torch.core import diloco
from repro_torch.data.sharding import make_regime
from repro_torch.launch.train import resolve_device
from repro_torch.models.registry import get_smoke_arch

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda")
device = resolve_device(ap.parse_args().device)

# 1. a model (smoke = the reduced width of a registered config)
arch = get_smoke_arch("diloco_150m")
loss_fn = lambda p, b: arch.loss(p, b)
gen = torch.Generator(device=device).manual_seed(0)
params = arch.init(generator=gen, device=device)

# 2. data: k shards with distinct distributions (the hard, non-i.i.d.
#    regime the paper defaults to)
K, H, ROUNDS, PER_CALL = 4, 10, 8, 4
sampler = make_regime("non_iid", k=K, vocab_size=arch.cfg.vocab_size,
                      device=device)
val = sampler.sample_validation(
    torch.Generator(device=device).manual_seed(42), 64, 64)

# 3. DiLoCo: inner AdamW, outer Nesterov (paper defaults)
dcfg = DiLoCoConfig(k=K, H=H)           # outer: Nesterov lr=0.7 mu=0.9
tcfg = TrainConfig(inner_lr=3e-3, warmup_steps=10,
                   total_steps=ROUNDS * H, batch_size=8, seq_len=64)
evaluate = diloco.make_eval(loss_fn)
print(f"start: val ppl = {np.exp(float(evaluate(params, val))):.1f} "
      f"(entropy floor {np.exp(sampler.entropy_floor()):.1f})")
state = diloco.init_state(params, dcfg)
run = diloco.make_run(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                      rounds_per_call=PER_CALL, batch_size=8, seq_len=64,
                      eval_tokens=val, eval_every=PER_CALL)

# 4. train: ONE cross-replica communication per round (every H steps);
#    each call runs PER_CALL rounds and returns their metrics stacked
for done in range(0, ROUNDS, PER_CALL):
    state, metrics = run(state, gen, round_offset=done)
    inner = metrics["inner_loss"].cpu().numpy()
    val_loss = metrics["val_loss"].cpu().numpy()
    for i in range(PER_CALL):
        ev = (f"  val ppl {np.exp(val_loss[i]):.1f}"
              if np.isfinite(val_loss[i]) else "")
        print(f"round {done + i + 1}: inner loss {inner[i]:.3f}{ev}")
print("each round ran", K, "replicas x", H, "AdamW steps with a single",
      "outer all-reduce - communication reduced", H, "x vs sync DDP")
