"""Per-neuron sign pruning: the CUDA kernels of ``csrc/sign_prune.cu`` and
their wrapper.

The wrapper prunes in place (``sign_prune_``), running the kernels on CUDA
tensors and the plain PyTorch version (``ref.sign_prune``) on CPU tensors;
a CUDA tensor goes to the kernels or raises. ``sign_prune_parts`` also
returns each row's elected sign and threshold, the quantities the kernels
are held to, bit for bit.

A matrix of rows up to ``RESIDENT_MAX_COLS`` long is pruned in one launch:
rows of up to 1024 entries a warp each, the row in registers; longer ones
a block each, the row in shared memory. Longer rows are shared by blocks
of ``CHUNK`` entries each and pruned in ``LONG_LAUNCHES`` = 5 launches,
for at most ``MAX_GRID_ROWS`` rows: the statistics, three count passes
that each resolve several of the 26 bisection steps at once (9, 9 and 8:
every block bins its entries by the tree of thresholds those steps can
visit, into a per-row histogram), and the mask. ``launches`` counts these CUDA launches and nothing else;
``launches_for`` says how many one pruning takes.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

launches = 0
RESIDENT_MAX_COLS = 49152        # 192 KB of float32 in one block's smem
CHUNK = 32768                    # entries of a long row per block
LONG_LAUNCHES = 5                # statistics, 3 count passes, mask
MAX_GRID_ROWS = 65535            # the grid's y dim
MAX_COLS = 2**31 - 1             # the per-row counts are 32-bit
_fns: dict = {}


def _kernel(entry: str):
    if entry not in _fns:
        lib = build.load("sign_prune")
        if "workspace" not in _fns:
            made = lib.repro_sign_prune_long_launches()
            if made != LONG_LAUNCHES:
                raise RuntimeError(f"csrc/sign_prune.cu makes {made} "
                                   f"launches a long row, LONG_LAUNCHES "
                                   f"says {LONG_LAUNCHES}")
            work = lib.repro_sign_prune_long_workspace
            work.restype = ctypes.c_longlong
            work.argtypes = [ctypes.c_longlong] * 3
            _fns["workspace"] = work
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        head = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_float] * 2
        if entry == "repro_sign_prune_long_f32":
            head += [ctypes.c_longlong, ctypes.c_void_p]
        fn.argtypes = head + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                      ctypes.c_void_p]
        _fns[entry] = fn
    return _fns[entry]


def launches_for(rows: int, cols: int) -> int:
    """CUDA launches of one pruning of a (rows, cols) matrix."""
    if rows == 0 or cols == 0:
        return 0
    return 1 if cols <= RESIDENT_MAX_COLS else LONG_LAUNCHES


def _launch(x, out, keep, sign, hi):
    """Prune (R, C) float32 ``x`` into ``out`` (may be ``x``) on the card;
    ``sign``/``hi`` (R,) receive each row's elected sign and threshold, or
    are None."""
    global launches
    R, C = x.shape
    if R == 0 or C == 0:
        return
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (keep, ref.HI_SCALE, ref.HI_FLOOR)
    if C <= RESIDENT_MAX_COLS:
        err = _kernel("repro_sign_prune_resident_f32")(
            x.data_ptr(), out.data_ptr(), R, C, *common,
            *_row_ptrs(sign, hi), dev.index or 0, stream)
        _raise(err)
        launches += 1
        return
    if R > MAX_GRID_ROWS or C > MAX_COLS:
        raise ValueError(f"sign_prune takes at most {MAX_GRID_ROWS} rows of "
                         f"more than {RESIDENT_MAX_COLS} and at most "
                         f"{MAX_COLS} columns, got {R} × {C}")
    fn = _kernel("repro_sign_prune_long_f32")
    work = torch.empty(_fns["workspace"](R, C, CHUNK), dtype=torch.uint8,
                       device=dev)
    err = fn(x.data_ptr(), out.data_ptr(), R, C, *common, CHUNK,
             work.data_ptr(), *_row_ptrs(sign, hi), dev.index or 0, stream)
    _raise(err)
    launches += LONG_LAUNCHES


def _row_ptrs(sign, hi):
    return (None, None) if sign is None else (sign.data_ptr(), hi.data_ptr())


def _raise(err):
    if err != 0:
        raise RuntimeError(f"sign_prune kernel launch failed: CUDA error "
                           f"{err}")


def _check(x):
    if x.dim() != 2:
        raise ValueError(f"sign_prune takes an (R, C) matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.device.type == "cuda":
        # the kernels read float32; the plain version takes any float
        build.check_operands("sign_prune", (x,), (torch.float32,))
    else:
        build.check_operands("sign_prune", (x,), (x.dtype,))


def sign_prune_parts(x, frac: float):
    """(elected sign (R, 1), threshold (R, 1), pruned x) of
    ``sign_prune(x, frac)``: the per-row quantities the kernels are held
    to."""
    _check(x)
    if x.device.type == "cpu":
        return ref.sign_prune_parts(x, frac)
    R, C = x.shape
    out = torch.empty_like(x)
    sign = torch.empty(R, dtype=torch.float32, device=x.device)
    hi = torch.empty(R, dtype=torch.float32, device=x.device)
    _launch(x, out, ref.keep_count(frac, C), sign, hi)
    return sign[:, None], hi[:, None], out


def sign_prune_(x, frac: float):
    """x: (R, C), pruned in place: per row, keep the entries that agree
    with the sign of the larger magnitude mass and lie in the top
    (1 - frac) by magnitude, zero the rest. Returns ``x``; ``frac <= 0``
    leaves it as it is."""
    if frac <= 0:
        return x
    _check(x)
    if x.device.type == "cpu":
        return x.copy_(ref.sign_prune(x, frac))
    _launch(x, x, ref.keep_count(frac, x.shape[1]), None, None)
    return x
