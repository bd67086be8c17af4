"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` and their
wrapper, the counterpart of the JAX ``kernels/flash_attention.py``.

Layout (the kernels' own, as in the JAX module): q (B, H, Sq, d), k/v
(B, G, Sk, d) with H % G == 0; any strides whose last dim is contiguous
and whose rows are 16-byte aligned, so the model's (B, S, H, d) tensors go
in as transposed views, without a copy.

  flash_fwd      o only (the TPU ``flash_attention``): the no-grad forward
  flash_fwd_lse  o and the per-row logsumexp (``_fwd_lse``)
  flash_bwd      dq, dk, dv from (q, k, v, o, lse, dO) (``_bwd``)
  FlashAttention the ``torch.autograd.Function`` of the last two
                 (``make_flash_attention_vjp``): the forward saves only
                 (q, k, v, o, lse); the backward recomputes p per tile
  flash_attention  FlashAttention where a gradient is needed, else
                 flash_fwd

Operands are float32 or bfloat16 (all of one dtype), as the Pallas
kernels take any float dtype, and the kernels compute what the Pallas
kernels compute, p and every product at f32 accuracy: on f32 operands in
split TF32; on bf16 operands the forward, dq and dk/dv keep q, k, v and
dO bf16 in shared memory and multiply on the bf16 tensor cores
(``wgmma``: two bf16 tensors exactly, a computed f32 operand such as p
or dS split into two bf16 parts). o, dq, dk and dv are written in the
operands' dtype; lse and delta are float32 whatever the operands' dtype
(the plain versions do the same).

Each function runs the kernels on CUDA tensors and the plain PyTorch
versions (``ref.flash_fwd_lse``, ``ref.flash_bwd``) on CPU tensors; a
CUDA tensor goes to a kernel or raises. ``launches`` counts each kernel's
launches (and nothing else), the bf16 kernels under their own keys
("fwd_bf16", ...).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

HEAD_DIMS = (64, 128)     # head dims the kernels are built for
# operand dtype -> the suffix of its kernels' entry points and counters
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNELS = ("fwd", "fwd_lse", "bwd_dq", "bwd_dkv")
launches = {**dict.fromkeys(KERNELS, 0),
            **dict.fromkeys((f"{n}_bf16" for n in KERNELS), 0)}
_fns: dict = {}


def counter(name: str, dtype) -> str:
    """The ``launches`` key of kernel ``name`` on ``dtype`` operands."""
    return name if dtype == torch.float32 else f"{name}_{DTYPES[dtype]}"


def _kernel(name: str, dtype):
    key = (name, dtype)
    if key not in _fns:
        fn = getattr(build.load("flash_attention"),
                     f"repro_flash_{name}_{DTYPES[dtype]}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        _fns[key] = fn
    return _fns[key]


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def _check(q, k, v, *more):
    """Raise unless the operands are what the kernels (on CUDA) or their
    plain versions (on the CPU) take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (B, H, Sq, d) and k, v "
                         f"(B, G, Sk, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or H % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (need H % G == 0)")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs Sq > 0 and Sk > 0")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes {list(DTYPES)} operands, "
                        f"got {q.dtype}")
    for t in (q, k, v, *more):
        if t.dtype != q.dtype:
            raise TypeError(f"flash attention operands of one dtype, got "
                            f"{t.dtype} beside {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash attention operands on {t.device} and "
                             f"{q.device}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, not "
                         f"{q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernels are built for head "
                         f"dims {HEAD_DIMS}, got {d}")
    for t in (q, k, v, *more):
        if not kernel_layout(t):
            raise ValueError(
                f"flash attention kernels need the last dim contiguous, "
                f"the other strides 16-byte multiples "
                f"({16 // t.element_size()} elements) and 16-byte aligned "
                f"data; got strides {t.stride()}")


def kernel_layout(t) -> bool:
    """Whether the kernels read ``t`` (4-d) as it lies in memory: every
    row starts on 16 bytes (the kernels copy rows in 16-byte chunks)."""
    step = 16 // t.element_size()
    return (t.stride(-1) == 1
            and all(s % step == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _launch(name, q, k, v, *, out, do=None, lse=None, delta=None,
            lse_out=None, dk=None, dv=None, causal, window, scale,
            q_offset):
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    strides = []
    for t in (q, k, v, do, out, dk, dv):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _kernel(name, q.dtype)(
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(out),
        ptr(lse_out), ptr(dk), ptr(dv),
        (ctypes.c_longlong * len(strides))(*strides),
        B, H, G, Sq, Sk, d, ref.f32(scale), int(causal), int(window),
        q_offset + (Sk - Sq if causal and Sq != Sk else 0),
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {name} launch failed: "
                           f"CUDA error {err}")
    launches[counter(name, q.dtype)] += 1


def flash_fwd(q, k, v, *, causal=True, window=0, scale=None, q_offset=0):
    """Attention output o (B, H, Sq, d), without the logsumexp."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return ref.flash_fwd_lse(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)[0]
    o = torch.empty_like(q)
    _launch("fwd", q, k, v, out=o, causal=causal, window=window,
            scale=scale, q_offset=q_offset)
    return o


def flash_fwd_lse(q, k, v, *, causal=True, window=0, scale=None,
                  q_offset=0):
    """(o (B, H, Sq, d), lse (B, H, Sq) float32)."""
    _check(q, k, v)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return ref.flash_fwd_lse(q, k, v, causal=causal, window=window,
                                 scale=scale, q_offset=q_offset)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fwd_lse", q, k, v, out=o, lse_out=lse, causal=causal,
            window=window, scale=scale, q_offset=q_offset)
    return o, lse


def flash_bwd(q, k, v, o, lse, do, *, causal=True, window=0, scale=None,
              q_offset=0):
    """(dq, dk, dv) of the attention output o = f(q, k, v) under the
    upstream gradient ``do``; dk, dv summed over each GQA group."""
    _check(q, k, v, o, do)
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return ref.flash_bwd(q, k, v, o, lse, do, causal=causal,
                             window=window, scale=scale, q_offset=q_offset)
    if lse.shape != q.shape[:3] or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous (B, H, Sq) tensor")
    # Δ = rowsum(dO∘O) in float32 stays a PyTorch expression, as in the
    # JAX package
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    opts = dict(causal=causal, window=window, scale=scale,
                q_offset=q_offset, do=do, lse=lse, delta=delta)
    _launch("bwd_dq", q, k, v, out=dq, **opts)
    _launch("bwd_dkv", q, k, v, out=None, dk=dk, dv=dv, **opts)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward launches ``fwd_lse``
    and saves only (q, k, v, o, lse); the backward launches ``bwd_dq`` and
    ``bwd_dkv``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = flash_fwd_lse(q, k, v, causal=causal, window=window,
                               scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not kernel_layout(do):
            do = do.contiguous()     # e.g. the expanded grad of a sum
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q (B, H, Sq, d), k/v (B, G, Sk, d) -> o (B, H, Sq, d). Where grad is
    enabled and an input requires it, the differentiable ``FlashAttention``
    (forward with lse); otherwise the lse-free forward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    return flash_fwd(q, k, v, causal=causal, window=window, scale=scale)
