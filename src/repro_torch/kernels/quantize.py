"""Low-precision outer-gradient transport: the CUDA kernel of
``csrc/quantize.cu`` and its wrapper.

``fake_quant`` takes a contiguous float32 matrix of ``rows`` rows (a
replica's flattened outer gradient per row; 1 for a single tensor) and
returns its quantize→dequantize round trip: int4 over blocks of 128
entries of a row, one float32 scale per block, or a cast to bfloat16 and
back. The wrapper runs the kernel on CUDA tensors and the plain PyTorch
version (``ref.fake_quant_rows``) on CPU tensors; a CUDA tensor goes to
the kernel or raises. ``launches`` counts the kernel's launches per mode
("int4", "bfloat16") and nothing else.

The JAX package's other quantize kernels (the packed wire codecs) are
not ported yet: ROADMAP.md lists them under the paths that carry them.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

MODES = {"int4": 0, "bfloat16": 1}       # transport dtype -> C mode
launches = dict.fromkeys(MODES, 0)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("quantize").repro_fake_quant_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def fake_quant(x, dtype: str, *, rows: int = 1, out=None):
    """Round trip of ``x`` (float32, contiguous, viewed as ``rows`` rows)
    at the transport ``dtype`` ("int4" or "bfloat16"; "float32" returns
    ``x``). Writes into ``out`` when given (it may be ``x``), else into a
    new tensor; returns the result, shaped as ``x``."""
    if dtype == "float32":
        return x
    if dtype not in MODES:
        raise ValueError(f"unknown transport dtype {dtype!r}")
    if out is None:
        out = torch.empty_like(x)
    build.check_operands("fake_quant", (x, out), (torch.float32,) * 2)
    if x.numel() % rows:
        raise ValueError(f"fake_quant: {x.numel()} entries do not make "
                         f"{rows} rows")
    n = x.numel() // rows if rows else 0
    if x.device.type == "cpu":
        return out.copy_(ref.fake_quant_rows(x.view(rows, n), dtype)
                         .view(x.shape))
    if x.numel() == 0:
        return out
    err = _kernel()(
        x.data_ptr(), out.data_ptr(), rows, n, MODES[dtype],
        ref.INV_INT4_LEVELS, ref.INT4_LEVELS, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error "
                           f"{err}")
    launches[dtype] += 1
    return out
