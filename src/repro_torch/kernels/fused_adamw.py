"""Fused AdamW updates: the CUDA kernels of ``csrc/fused_adamw.cu`` and
their wrappers.

  fused_adamw        p, g, m, v at one storage dtype (float32, or bfloat16
                     under the pure-bf16 policy), maths in float32;
  fused_adamw_mixed  bf16 g, m, v and the float32 master in; the master,
                     m, v and the bf16 working copy out, in one pass.

The wrappers run the kernels on CUDA tensors and the plain PyTorch
versions (``ref.fused_adamw``, ``ref.fused_adamw_mixed``) on CPU tensors;
a CUDA tensor goes to a kernel or raises. ``launches`` counts each
kernel's launches and nothing else, so a run can show that its path went
through the kernel: ``fused_adamw`` (float32), ``fused_adamw_bf16`` and
``fused_adamw_mixed``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_fns: dict = {}
# storage dtype -> C entry point of fused_adamw
_ENTRY = {torch.float32: "repro_fused_adamw_f32",
          torch.bfloat16: "repro_fused_adamw_bf16"}
# C entry point -> the name its launches are counted under
_COUNTED_AS = {"repro_fused_adamw_f32": "fused_adamw",
               "repro_fused_adamw_bf16": "fused_adamw_bf16",
               "repro_fused_adamw_mixed": "fused_adamw_mixed"}
launches = dict.fromkeys(_COUNTED_AS.values(), 0)
MIXED = (torch.bfloat16,) * 3 + (torch.float32,)     # g, m, v, master


def _kernel(entry: str):
    if entry not in _fns:
        fn = getattr(build.load("fused_adamw"), entry)
        fn.restype = ctypes.c_int
        n_ptrs = 8 if entry == "repro_fused_adamw_mixed" else 7
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong]
                       + [ctypes.c_float] * 9
                       + [ctypes.c_int, ctypes.c_void_p])
        _fns[entry] = fn
    return _fns[entry]


def _scalars(lr, c1, c2, b1, b2, eps, weight_decay):
    return (ref.f32(lr), ref.f32(c1), ref.f32(c2), ref.f32(b1),
            ref.f32(1.0 - b1), ref.f32(b2), ref.f32(1.0 - b2), ref.f32(eps),
            ref.f32(weight_decay))


def _launch(entry, ins, outs, **hp):
    """One launch of C entry ``entry`` over the operands' elements."""
    n = ins[0].numel()
    if n == 0:
        return
    dev = ins[0].device
    err = _kernel(entry)(
        *(t.data_ptr() for t in (*ins, *outs)), n, *_scalars(**hp),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    launches[_COUNTED_AS[entry]] += 1


def _check(p, g, m, v):
    if p.dtype not in _ENTRY:
        raise TypeError(f"fused_adamw takes float32 or bfloat16 tensors, got "
                        f"{p.dtype}")
    build.check_operands("fused_adamw", (p, g, m, v), (p.dtype,) * 4)


def fused_adamw(p, g, m, v, *, lr, c1, c2, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1):
    """One AdamW step on one tensor of any shape, all four operands float32
    or all bfloat16. Returns new (p, m, v); the inputs are left as they
    were."""
    _check(p, g, m, v)
    hp = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if p.device.type == "cpu":
        return ref.fused_adamw(p, g, m, v, **hp)
    outs = tuple(torch.empty_like(t) for t in (p, m, v))
    _launch(_ENTRY[p.dtype], (p, g, m, v), outs, **hp)
    return outs


def fused_adamw_(p, g, m, v, *, lr, c1, c2, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    """In-place form of ``fused_adamw``: writes the new p, m, v over the
    old ones (the counterpart of the JAX driver donating the state)."""
    _check(p, g, m, v)
    hp = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if p.device.type == "cpu":
        for dst, src in zip((p, m, v), ref.fused_adamw(p, g, m, v, **hp)):
            dst.copy_(src)
        return
    _launch(_ENTRY[p.dtype], (p, g, m, v), (p, m, v), **hp)


def fused_adamw_mixed(g, m, v, master, *, lr, c1, c2, b1=0.9, b2=0.95,
                      eps=1e-8, weight_decay=0.1):
    """One mixed-precision AdamW step on one tensor of any shape: bf16 g,
    m, v and the float32 master. Returns new (p_working bf16, m, v,
    master); the inputs are left as they were."""
    build.check_operands("fused_adamw_mixed", (g, m, v, master), MIXED)
    hp = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if g.device.type == "cpu":
        return ref.fused_adamw_mixed(g, m, v, master, **hp)
    outs = (torch.empty_like(g), torch.empty_like(m), torch.empty_like(v),
            torch.empty_like(master))
    _launch("repro_fused_adamw_mixed", (g, m, v, master), outs, **hp)
    return outs


def fused_adamw_mixed_(p, g, m, v, master, *, lr, c1, c2, b1=0.9, b2=0.95,
                       eps=1e-8, weight_decay=0.1):
    """In-place form of ``fused_adamw_mixed``: writes the new working copy
    over ``p`` (bf16) and the new m, v and master over the old ones."""
    build.check_operands("fused_adamw_mixed", (p, g, m, v, master),
                         (torch.bfloat16,) + MIXED)
    hp = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    if g.device.type == "cpu":
        outs = ref.fused_adamw_mixed(g, m, v, master, **hp)
        for dst, src in zip((p, m, v, master), outs):
            dst.copy_(src)
        return
    _launch("repro_fused_adamw_mixed", (g, m, v, master), (p, m, v, master),
            **hp)
