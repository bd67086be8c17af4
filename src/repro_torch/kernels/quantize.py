"""Low-precision outer-gradient transport: the CUDA kernels of
``csrc/quantize.cu`` and their wrappers.

``fake_quant`` takes a contiguous float32 matrix of ``rows`` rows (a
replica's flattened outer gradient per row; 1 for a single tensor) and
returns its quantize→dequantize round trip: int4 over blocks of 128
entries of a row, one float32 scale per block, or a cast to bfloat16 and
back. ``quantize_pack_int4`` and ``unpack_dequantize_int4`` are the
sender and receiver of the packed int4 wire (``ref.wire_encode_int4``
gives its layout): one uint8 buffer of nibble-packed codes, padding and
block scales over a flat float32 vector. ``unpack_dequantize_reduce`` is
the sharded transport's deferred consumer: k gathered wires of one region
decoded and summed under a mask in one launch. ``quantize_int4``,
``dequantize_int4``, ``pack_int4`` and ``unpack_int4`` are the unfused
codec pieces on the (R, 128) block layout.

Each wrapper runs its kernel on CUDA tensors and the plain PyTorch
version (``ref.fake_quant_rows``, ``ref.wire_encode_int4``,
``ref.wire_decode_int4``, ``ref.wire_reduce_int4``, ``ref.quantize_int4``,
...) on CPU tensors; a CUDA tensor goes to the kernel or raises.
``launches`` counts each kernel's launches ("int4" and "bfloat16" for
``fake_quant``'s two modes, and one key for each other kernel) and
nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

MODES = {"int4": 0, "bfloat16": 1}       # transport dtype -> C mode
launches = {**dict.fromkeys(MODES, 0), "quantize_pack_int4": 0,
            "unpack_dequantize_int4": 0, "unpack_dequantize_reduce": 0,
            "quantize_int4": 0, "dequantize_int4": 0, "pack_int4": 0,
            "unpack_int4": 0}
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry point -> its argument types
_ARGTYPES = {
    "repro_fake_quant_f32": [_P, _P, _L, _L, _I, _F, _F, _I, _P],
    "repro_quantize_pack_int4": [_P, _P, _P, _L, _F, _F, _I, _P],
    "repro_unpack_dequantize_int4": [_P, _P, _L, _I, _P],
    "repro_unpack_dequantize_reduce": [_P, _L, _P, _P, _I, _L, _I, _P],
    "repro_quantize_int4": [_P, _P, _P, _L, _F, _F, _I, _P],
    "repro_dequantize_int4": [_P, _P, _P, _L, _I, _P],
    "repro_pack_int4": [_P, _P, _L, _I, _P],
    "repro_unpack_int4": [_P, _P, _L, _I, _P],
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


def unpack_dequantize_reduce(gathered, n: int, m, out=None):
    """Decode the k packed int4 wires of one region of ``n`` entries, the
    rows of ``gathered`` (k, W) uint8 (a row's W bytes contiguous; a
    column slice of a larger gathered buffer is taken in place), and sum
    them weighted by the float32 mask ``m`` (k,) into the flat float32
    ``out`` (a new tensor when not given). Returns ``out``."""
    if gathered.dtype != torch.uint8 or gathered.dim() != 2 \
            or gathered.stride(1) != 1:
        raise TypeError("unpack_dequantize_reduce: the gathered wires are a "
                        "(k, W) uint8 tensor with contiguous rows, got "
                        f"{gathered.dtype} of shape {tuple(gathered.shape)}")
    k, W = gathered.shape
    cb, pad, rows = ref.wire_sections(n)
    if W != cb + pad + 4 * rows:
        raise ValueError(f"unpack_dequantize_reduce: {n} entries take wires "
                         f"of {cb + pad + 4 * rows} bytes, got {W}")
    if out is None:
        out = torch.empty((n,), dtype=torch.float32, device=gathered.device)
    build.check_operands("unpack_dequantize_reduce", (out,),
                         (torch.float32,))
    if m.dtype != torch.float32 or tuple(m.shape) != (k,) \
            or not m.is_contiguous():
        raise TypeError("unpack_dequantize_reduce: the mask is a contiguous "
                        f"({k},) float32 tensor, got {m.dtype} "
                        f"{tuple(m.shape)}")
    if out.numel() != n or out.device != gathered.device \
            or m.device != gathered.device:
        raise ValueError(f"unpack_dequantize_reduce: out holds {out.numel()} "
                         f"entries on {out.device}, the mask lies on "
                         f"{m.device}; want {n} on {gathered.device}")
    if gathered.device.type == "cpu":
        return out.view(-1).copy_(ref.wire_reduce_int4(gathered, n, m)) \
            .view(out.shape)
    if n == 0:
        return out
    if gathered.data_ptr() % 4 or (gathered.stride(0) % 4 and k > 1):
        raise ValueError("unpack_dequantize_reduce: each wire must start on "
                         "a 4-byte boundary (its scales are float32 words)")
    err = _kernel("repro_unpack_dequantize_reduce")(
        gathered.data_ptr(), gathered.stride(0), m.data_ptr(),
        out.data_ptr(), k, n, gathered.device.index or 0,
        torch.cuda.current_stream(gathered.device).cuda_stream)
    _raise_on(err, "unpack_dequantize_reduce")
    launches["unpack_dequantize_reduce"] += 1
    return out


def _check_blocks(name: str, t, dtype, cols: int):
    if t.dtype != dtype or t.dim() != 2 or t.shape[1] != cols \
            or not t.is_contiguous():
        raise TypeError(f"{name}: takes a contiguous (R, {cols}) {dtype} "
                        f"tensor, got {t.dtype} of shape {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not "
                         f"{t.device}")


def _launch(name: str, device, *args):
    err = _kernel("repro_" + name)(*args, device.index or 0,
                                   torch.cuda.current_stream(device)
                                   .cuda_stream)
    _raise_on(err, name)
    launches[name] += 1


def quantize_int4(x):
    """(R, 128) float32 blocks -> (codes (R, 128) int8 in [-7, 7], scales
    (R, 1) float32), as ``ref.quantize_int4``."""
    _check_blocks("quantize_int4", x, torch.float32, ref.QUANT_BLOCK)
    if x.device.type == "cpu":
        return ref.quantize_int4(x)
    rows = x.shape[0]
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows:
        _launch("quantize_int4", x.device, x.data_ptr(), codes.data_ptr(),
                scales.data_ptr(), rows, ref.INV_INT4_LEVELS,
                ref.INT4_LEVELS)
    return codes, scales


def dequantize_int4(codes, scales):
    """(R, 128) int8 codes × (R, 1) float32 scales -> (R, 128) float32, as
    ``ref.dequantize_int4``."""
    _check_blocks("dequantize_int4", codes, torch.int8, ref.QUANT_BLOCK)
    rows = codes.shape[0]
    _check_blocks("dequantize_int4", scales, torch.float32, 1)
    if scales.shape[0] != rows or scales.device != codes.device:
        raise ValueError(f"dequantize_int4: {rows} rows of codes on "
                         f"{codes.device}, scales {tuple(scales.shape)} on "
                         f"{scales.device}")
    if codes.device.type == "cpu":
        return ref.dequantize_int4(codes, scales)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    if rows:
        _launch("dequantize_int4", codes.device, codes.data_ptr(),
                scales.data_ptr(), out.data_ptr(), rows)
    return out


def pack_int4(codes):
    """Nibble-pack (R, 128) int8 codes into (R, 64) int8 wire bytes (lane
    2j in the low nibble, 2j+1 in the high one), as ``ref.pack_int4`` on
    the flat codes."""
    _check_blocks("pack_int4", codes, torch.int8, ref.QUANT_BLOCK)
    rows = codes.shape[0]
    if codes.device.type == "cpu":
        return ref.pack_int4(codes.reshape(-1)).reshape(rows, -1)
    out = torch.empty((rows, ref.QUANT_BLOCK // 2), dtype=torch.int8,
                      device=codes.device)
    if rows:
        _launch("pack_int4", codes.device, codes.data_ptr(), out.data_ptr(),
                rows)
    return out


def unpack_int4(packed):
    """Inverse of ``pack_int4``: (R, 64) int8 bytes -> (R, 128) int8 codes
    in [-7, 7], sign-extended, as ``ref.unpack_int4``."""
    _check_blocks("unpack_int4", packed, torch.int8, ref.QUANT_BLOCK // 2)
    rows = packed.shape[0]
    if packed.device.type == "cpu":
        return ref.unpack_int4(packed.reshape(-1), rows * ref.QUANT_BLOCK
                               ).reshape(rows, -1)
    out = torch.empty((rows, ref.QUANT_BLOCK), dtype=torch.int8,
                      device=packed.device)
    if rows:
        _launch("unpack_int4", packed.device, packed.data_ptr(),
                out.data_ptr(), rows)
    return out
