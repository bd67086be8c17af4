"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The libraries go into ``build/repro_torch_kernels/`` at the root of the
checkout, named by a hash of the source and its flags: a changed source
builds anew, an unchanged one is loaded as it is. The build runs at first
use; ``build_all`` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
# --fmad=false: no multiply-add contraction, so the optimizer kernels
# round where their plain PyTorch versions round (bitwise agreement).
# Attention is held to a tolerance and contracts its dot products.
BITWISE = ("--fmad=false",)
SOURCES = {    # name -> (source, flags of its own)
    "fused_adamw": (CSRC / "fused_adamw.cu", BITWISE),
    "outer_nesterov": (CSRC / "outer_nesterov.cu", BITWISE),
    "flash_attention": (CSRC / "flash_attention.cu", ()),
    "sign_prune": (CSRC / "sign_prune.cu", BITWISE),
    "quantize": (CSRC / "quantize.cu", BITWISE),
}
# -Xptxas -v reports registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}       # name -> ctypes.CDLL, one load per process
build_log: dict = {}     # name -> {"seconds": float, "ptxas": str}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCES[name][1]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name][0].read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one nvcc process per source, all started together. Returns
    ``{name: seconds}`` for the ones it compiled."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.time()
    for n in todo:
        tmp = lib_path(n).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [exe, *flags(n), "-o", str(tmp), str(SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    done, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib_path(n))     # atomic: readers never see half
        done[n] = time.time() - t0
        build_log[n] = {"seconds": done[n], "ptxas": out.strip()}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return _loaded[name]


def check_operands(name: str, tensors, dtypes) -> None:
    """Raise unless ``tensors`` are contiguous, of one size and on one
    device, the CPU or a CUDA card, and each has the dtype at its place in
    ``dtypes`` (kernel ``name``'s own rule): what the kernel and its plain
    version take."""
    first = tensors[0]
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not "
                         f"{first.device}")
    for t, dt in zip(tensors, dtypes, strict=True):
        if t.dtype != dt:
            raise TypeError(f"{name} takes {[str(d) for d in dtypes]} "
                            f"operands, got {t.dtype} where {dt} belongs")
        if t.device != first.device:
            raise ValueError(f"{name} operands on {t.device} and "
                             f"{first.device}")
        if t.numel() != first.numel():
            raise ValueError(f"{name} operand sizes differ: {t.numel()} vs "
                             f"{first.numel()}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
