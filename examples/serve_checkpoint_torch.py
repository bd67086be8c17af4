"""Serving scenario on the PyTorch + CUDA port: batched generation from a
DiLoCo-trained model (the JAX ``examples/serve_checkpoint.py``).

Trains briefly with DiLoCo, checkpoints the global params, restores them
in a "server" and decodes a batch of prompts: the DiLoCo model is an
ordinary checkpoint (same size and speed as synchronous training would
produce). Works with any registered architecture (``--arch zamba2_2_7b``
serves the hybrid SSM; ``--arch whisper_large_v3`` the encoder-decoder,
etc.). Runs on the GPU by default; ``--device cpu`` runs the plain
PyTorch versions.

  PYTHONPATH=src python examples/serve_checkpoint_torch.py [--arch ID]
"""
import argparse
import os
import tempfile

import torch

from repro_torch import tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import DiLoCoConfig, TrainConfig
from repro_torch.core import diloco
from repro_torch.data.sharding import make_regime
from repro_torch.launch.serve import greedy_decode, modality_inputs
from repro_torch.launch.train import resolve_device
from repro_torch.models.registry import get_smoke_arch

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda")
ap.add_argument("--arch", default="stablelm_1_6b")
ap.add_argument("--rounds", type=int, default=4)
ap.add_argument("--H", type=int, default=10)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--gen", type=int, default=16)
args = ap.parse_args()
device = resolve_device(args.device)

arch = get_smoke_arch(args.arch)
cfg = arch.cfg
loss_fn = lambda p, b: arch.loss(p, b)
params = arch.init(generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
sampler = make_regime("iid", k=4, vocab_size=cfg.vocab_size, device=device)

# --- train a little with DiLoCo and checkpoint the global copy ---
# (the VLM and whisper need their modality input in every batch, which
# the token sampler does not draw: they are served from their init)
if cfg.family not in ("vlm", "encdec"):
    dcfg = DiLoCoConfig(k=4, H=args.H)
    tcfg = TrainConfig(inner_lr=3e-3, warmup_steps=10,
                       total_steps=args.rounds * args.H, batch_size=8,
                       seq_len=64)
    state = diloco.init_state(params, dcfg)
    rnd = diloco.make_round(loss_fn, sampler.sample_all_shards, dcfg, tcfg,
                            batch_size=8, seq_len=64)
    gen = torch.Generator(device=device).manual_seed(1)
    for t in range(args.rounds):
        state, m = rnd(state, gen)
        print(f"train round {t + 1}: inner {float(m['inner_loss']):.3f}")
    params = state.global_params
with tempfile.TemporaryDirectory(prefix="diloco_serve_") as tmp:
    path = os.path.join(tmp, "ckpt.npz")
    ckpt.save(path, {"params": params})
    print("saved", path)

    # --- "server": restore and decode a batch ---
    like = {"params": tree.map(torch.zeros_like, params)}
    served = ckpt.restore(path, like)["params"]
prompts = sampler.sample_validation(
    torch.Generator(device=device).manual_seed(7), args.batch, 32)
extra = modality_inputs(cfg, args.batch, 8, device)
toks = greedy_decode(arch, served, prompts, gen=args.gen, extra=extra)
print(f"decoded {args.batch}x{args.gen} tokens from the restored "
      f"checkpoint ({cfg.name}):")
print(toks.cpu().numpy())
