"""Fused outer Nesterov update: the CUDA kernel ``csrc/outer_nesterov.cu``
and its wrapper.

The wrapper runs the kernel on CUDA tensors and the plain PyTorch version
(``ref.outer_nesterov``) on CPU tensors; a CUDA tensor goes to the kernel
or raises. ``launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

launches = 0
_fn = None
F32x3 = (torch.float32,) * 3     # θ, Δ and the buffer: the globals' dtype


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("outer_nesterov").repro_outer_nesterov_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def _launch(p, delta, buf, p_out, b_out, *, lr, momentum):
    global launches
    n = p.numel()
    if n == 0:
        return
    err = _kernel()(
        p.data_ptr(), delta.data_ptr(), buf.data_ptr(), p_out.data_ptr(),
        b_out.data_ptr(), n, ref.f32(lr), ref.f32(momentum),
        p.device.index or 0, torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"outer_nesterov kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1


def outer_nesterov(p, delta, buf, *, lr, momentum=0.9):
    """θ ← θ − lr·(μ·b_new + Δ), b_new = μ·b + Δ on one tensor of any
    shape. Returns new (p, buf); the inputs are left as they were."""
    build.check_operands("outer_nesterov", (p, delta, buf), F32x3)
    if p.device.type == "cpu":
        return ref.outer_nesterov(p, delta, buf, lr=lr, momentum=momentum)
    outs = (torch.empty_like(p), torch.empty_like(buf))
    _launch(p, delta, buf, *outs, lr=lr, momentum=momentum)
    return outs


def outer_nesterov_(p, delta, buf, *, lr, momentum=0.9):
    """In-place form of ``outer_nesterov``: writes the new θ and buffer
    over the old ones."""
    build.check_operands("outer_nesterov", (p, delta, buf), F32x3)
    if p.device.type == "cpu":
        new_p, new_b = ref.outer_nesterov(p, delta, buf, lr=lr,
                                          momentum=momentum)
        p.copy_(new_p)
        buf.copy_(new_b)
        return
    _launch(p, delta, buf, p, buf, lr=lr, momentum=momentum)
