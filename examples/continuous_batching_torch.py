"""Continuous-batching serving demo on the PyTorch + CUDA port (the JAX
``examples/continuous_batching.py``).

Eight requests with different prompt/generation lengths stream through
a 3-slot engine (``repro_torch.launch.batching.ContinuousBatcher``, paged
cache): finished slots refill immediately, one batched decode per tick,
and every request's tokens are those of running it alone (shared-clock
RoPE alignment, see ``launch/batching.py``). Runs on the GPU by default;
``--device cpu`` runs the plain PyTorch versions.

  PYTHONPATH=src python examples/continuous_batching_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.launch.batching import ContinuousBatcher
from repro_torch.launch.train import resolve_device
from repro_torch.models.registry import get_smoke_arch

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda")
ap.add_argument("--requests", type=int, default=8)
args = ap.parse_args()
device = resolve_device(args.device)

arch = get_smoke_arch("qwen3_32b")
params = arch.init(generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
eng = ContinuousBatcher(arch, params, slots=3, cache_len=128)

rng = np.random.default_rng(0)
reqs = []
for i in range(args.requests):
    L = int(rng.integers(4, 24))
    gen = int(rng.integers(4, 16))
    rid = eng.submit(rng.integers(0, arch.cfg.vocab_size, L), gen)
    reqs.append((rid, L, gen))
    print(f"submitted rid={rid} prompt={L} gen={gen}")

t0 = time.time()
ticks = 0
while eng.queue or any(r is not None for r in eng.active):
    eng.tick()
    ticks += 1
    if ticks % 5 == 0:
        print(f"tick {ticks:3d}: utilization {eng.utilization:.0%}, "
              f"{len(eng.finished)}/{len(reqs)} done")
out = eng.finished
dt = time.time() - t0
total = sum(len(v) for v in out.values())
print(f"\n{len(out)} requests, {total} tokens in {ticks} ticks "
      f"({dt:.1f}s on {device})")
serial_ticks = sum(g for _, _, g in reqs)
print(f"serial decode would take {serial_ticks} ticks -> continuous "
      f"batching gave {serial_ticks / ticks:.1f}x tick-level speedup "
      f"on 3 slots")
for rid, L, gen in reqs:
    print(f"  rid={rid}: {out[rid][:8].tolist()}{'...' if gen > 8 else ''}")
