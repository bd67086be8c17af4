#!/usr/bin/env python3
"""The ceiling of the flash-attention kernels' products on one NVIDIA GPU.

    python3 tools/flash_probe.py

Imports nothing of JAX. Needs the CUDA toolkit's nvcc (as the port's
kernel build does). Prints the card's name and power limit, then one JSON
line per measurement: the rate of mma.sync m16n8k8 TF32 products (the
only product the forward, dq and dk/dv kernels issue) with independent
accumulator chains, by warps per block, blocks per SM and chains per
warp; then, for each kernel, the best of those rates at its own launch
shape (``LAUNCH``), the ceiling that PERF.md gives each kernel's MMA
rate a share of.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "flash_probe"
# each kernel's launch shape (csrc/flash_attention.cu): 256 threads a
# block, and one block per SM (the shared memory and ptxas's registers
# leave room for no second one)
LAUNCH = {"flash_fwd_kernel": (8, 1), "flash_dq_kernel": (8, 1),
          "flash_dkv_kernel": (8, 1)}

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NCH>
__global__ void mma_chains(float* out, int iters) {
  float acc[NCH][4];
  for (int c = 0; c < NCH; ++c)
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const uint32_t a[4] = {0x3f800000u, 0x3f000000u, threadIdx.x, 7u};
  const uint32_t b[2] = {0x3e800000u, 0x3f400000u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float s = 0.f;
  for (int c = 0; c < NCH; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(float* out, int blocks, int threads, int iters,
                        int chains) {
  if (chains == 4) mma_chains<4><<<blocks, threads>>>(out, iters);
  if (chains == 8) mma_chains<8><<<blocks, threads>>>(out, iters);
  if (chains == 16) mma_chains<16><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.card_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)

    cu, so = OUT / "mma_peak.cu", OUT / "mma_peak.so"
    cu.write_text(MMA_PEAK_CU)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS[:-2], "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    peak = ctypes.CDLL(str(so)).mma_peak
    peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 2 * 512, device="cuda")
    iters = 4096
    rates = {}
    for warps in (4, 8, 16):
        for per_sm in (1, 2):
            for chains in (4, 8, 16):
                blocks = sms * per_sm
                ms = CS.time_ms(torch, lambda: peak(
                    out.data_ptr(), blocks, 32 * warps, iters, chains),
                    reps=5, warmup=2)
                flops = 2 * 16 * 8 * 8 * iters * chains * warps * blocks
                rate = flops / ms / 1e9
                rates[warps, per_sm] = max(rates.get((warps, per_sm), 0.0),
                                           rate)
                print(json.dumps({"probe": "mma_peak", "warps_per_block":
                                  warps, "blocks_per_sm": per_sm,
                                  "chains": chains, "ms": ms,
                                  "TFLOPs": rate}), flush=True)
    for kernel, (warps, per_sm) in LAUNCH.items():
        print(json.dumps({"probe": "launch_shape", "kernel": kernel,
                          "warps_per_block": warps, "blocks_per_sm": per_sm,
                          "mma_TFLOPs": rates[warps, per_sm]}), flush=True)

    print(CS.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
