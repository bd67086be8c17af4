"""Low-precision outer-gradient transport: the CUDA kernels of
``csrc/quantize.cu`` and their wrappers.

``fake_quant`` takes a contiguous float32 matrix of ``rows`` rows (a
replica's flattened outer gradient per row; 1 for a single tensor) and
returns its quantize→dequantize round trip: int4 over blocks of 128
entries of a row, one float32 scale per block, or a cast to bfloat16 and
back. ``quantize_pack_int4`` and ``unpack_dequantize_int4`` are the
sender and receiver of the packed int4 wire (``ref.wire_encode_int4``
gives its layout): one uint8 buffer of nibble-packed codes, padding and
block scales over a flat float32 vector.

Each wrapper runs its kernel on CUDA tensors and the plain PyTorch
version (``ref.fake_quant_rows``, ``ref.wire_encode_int4``,
``ref.wire_decode_int4``) on CPU tensors; a CUDA tensor goes to the
kernel or raises. ``launches`` counts each kernel's launches ("int4" and
"bfloat16" for ``fake_quant``'s two modes, and one key per wire codec)
and nothing else.

The JAX package's other quantize kernels (the unfused codec pieces and
the sharded transport's ``unpack_dequantize_reduce``) are not ported yet:
ROADMAP.md lists them under the paths that carry them.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

MODES = {"int4": 0, "bfloat16": 1}       # transport dtype -> C mode
launches = {**dict.fromkeys(MODES, 0), "quantize_pack_int4": 0,
            "unpack_dequantize_int4": 0}
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry point -> its argument types
_ARGTYPES = {
    "repro_fake_quant_f32": [_P, _P, _L, _L, _I, _F, _F, _I, _P],
    "repro_quantize_pack_int4": [_P, _P, _P, _L, _F, _F, _I, _P],
    "repro_unpack_dequantize_int4": [_P, _P, _L, _I, _P],
}
_fns: dict = {}


def _kernel(name: str = "repro_fake_quant_f32"):
    if name not in _fns:
        fn = getattr(build.load("quantize"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return _fns[name]


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


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
    _raise_on(err, "fake_quant")
    launches[dtype] += 1
    return out


def _check_wire(name: str, wire, n: int):
    if wire.dtype != torch.uint8 or wire.dim() != 1 \
            or not wire.is_contiguous():
        raise TypeError(f"{name}: the wire is a contiguous 1-d uint8 "
                        f"tensor, got {wire.dtype} of shape "
                        f"{tuple(wire.shape)}")
    cb, pad, rows = ref.wire_sections(n)
    if wire.numel() != cb + pad + 4 * rows:
        raise ValueError(f"{name}: {n} entries take a wire of "
                         f"{cb + pad + 4 * rows} bytes, got {wire.numel()}")
    if wire.device.type == "cuda" and wire.data_ptr() % 4:
        raise ValueError(f"{name}: the wire must start on a 4-byte "
                         "boundary (its scales are float32 words)")


def quantize_pack_int4(x, wire, local=None):
    """Encode the flat float32 ``x`` (contiguous, n entries) into the
    packed int4 ``wire`` (uint8, ``ref.wire_sections(n)``'s size), and
    write the local values clip(q)·scale into ``local`` (float32, n) when
    it is given. Returns ``wire``."""
    ops_ = (x,) if local is None else (x, local)
    build.check_operands("quantize_pack_int4", ops_,
                         (torch.float32,) * len(ops_))
    n = x.numel()
    _check_wire("quantize_pack_int4", wire, n)
    if wire.device != x.device:
        raise ValueError(f"quantize_pack_int4: x on {x.device}, the wire "
                         f"on {wire.device}")
    if x.device.type == "cpu":
        w, loc = ref.wire_encode_int4(x.reshape(-1))
        wire.copy_(w)
        if local is not None:
            local.view(-1).copy_(loc)
        return wire
    if n == 0:
        return wire
    err = _kernel("repro_quantize_pack_int4")(
        x.data_ptr(), wire.data_ptr(),
        None if local is None else local.data_ptr(), n,
        ref.INV_INT4_LEVELS, ref.INT4_LEVELS, x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, "quantize_pack_int4")
    launches["quantize_pack_int4"] += 1
    return wire


def unpack_dequantize_int4(wire, n: int, out=None):
    """Decode the packed int4 ``wire`` of ``n`` entries into the flat
    float32 ``out`` (a new tensor when not given). Returns ``out``."""
    _check_wire("unpack_dequantize_int4", wire, n)
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=wire.device)
    build.check_operands("unpack_dequantize_int4", (out,), (torch.float32,))
    if out.numel() != n or out.device != wire.device:
        raise ValueError(f"unpack_dequantize_int4: out holds {out.numel()} "
                         f"entries on {out.device}, want {n} on "
                         f"{wire.device}")
    if wire.device.type == "cpu":
        return out.view(-1).copy_(ref.wire_decode_int4(wire, n)) \
            .view(out.shape)
    if n == 0:
        return out
    err = _kernel("repro_unpack_dequantize_int4")(
        wire.data_ptr(), out.data_ptr(), n, wire.device.index or 0,
        torch.cuda.current_stream(wire.device).cuda_stream)
    _raise_on(err, "unpack_dequantize_int4")
    launches["unpack_dequantize_int4"] += 1
    return out
