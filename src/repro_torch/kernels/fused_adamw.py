"""Fused AdamW update: the CUDA kernel ``csrc/fused_adamw.cu`` and its
wrapper.

The wrapper runs the kernel on CUDA tensors and the plain PyTorch version
(``ref.fused_adamw``) on CPU tensors; a CUDA tensor goes to the kernel or
raises. ``launches`` counts kernel launches (and nothing else), so a run
can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("fused_adamw").repro_fused_adamw_f32
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 9
                       + [ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def _launch(p, g, m, v, p_out, m_out, v_out, *, lr, c1, c2, b1, b2, eps,
            weight_decay):
    global launches
    n = p.numel()
    if n == 0:
        return
    err = _kernel()(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(), n,
        ref.f32(lr), ref.f32(c1), ref.f32(c2), ref.f32(b1),
        ref.f32(1.0 - b1), ref.f32(b2), ref.f32(1.0 - b2), ref.f32(eps),
        ref.f32(weight_decay), p.device.index or 0,
        torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1


def fused_adamw(p, g, m, v, *, lr, c1, c2, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1):
    """One AdamW step on one tensor of any shape. Returns new
    (p, m, v); the inputs are left as they were."""
    build.check_operands("fused_adamw", (p, g, m, v))
    if p.device.type == "cpu":
        return ref.fused_adamw(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay, c1=c1, c2=c2)
    outs = tuple(torch.empty_like(t) for t in (p, m, v))
    _launch(p, g, m, v, *outs, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay)
    return outs


def fused_adamw_(p, g, m, v, *, lr, c1, c2, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """In-place form of ``fused_adamw``: writes the new p, m, v over the
    old ones (the counterpart of the JAX driver donating the state)."""
    build.check_operands("fused_adamw", (p, g, m, v))
    if p.device.type == "cpu":
        outs = ref.fused_adamw(p, g, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                               weight_decay=weight_decay, c1=c1, c2=c2)
        for dst, src in zip((p, m, v), outs):
            dst.copy_(src)
        return
    _launch(p, g, m, v, p, m, v, lr=lr, c1=c1, c2=c2, b1=b1, b2=b2,
            eps=eps, weight_decay=weight_decay)
