"""The flash-attention kernels' tensor-core arithmetic, emulated on the CPU
(shared by ``test_torch_flash_tf32.py``, the forward, and
``test_torch_flash_bwd_tf32.py``, the backward).

``csrc/flash_attention.cu`` splits each f32 operand x into big = rna(x),
its nearest tf32 (10 mantissa bits, ties away from zero, as
``cvt.rna.tf32.f32``), and small, the tf32 of the remainder x − big: the
forward rounds small to the nearest tf32 too, the backward hands the
remainder to the MMA as it is, which reads only a tf32 operand's top 19
bits (small truncated toward zero). Each m16n8k8 product is three MMAs,
big·small, small·big, big·big, into an f32 accumulator; each MMA sums
its 8 products (exact: two tf32 values multiply exactly) and its
accumulator and rounds the sum toward zero to f32, as the tensor cores
do. The emulation sums exactly before that one rounding, so it is
kinder than the card, whose alignment of the terms drops bits too.
"""
from __future__ import annotations

import torch


def tf32_rna(x):
    """Round float32 ``x`` to the nearest tf32, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x):
    """Float32 ``x`` as a tf32 MMA operand reads it: its low 13 mantissa
    bits dropped (toward zero)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def f32_rz(x):
    """Float64 ``x`` rounded toward zero to float32."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mma(c, a, b, passes=3, small=tf32_rna):
    """c + a @ b (c float32 (.., m, n), a (.., m, 8), b (.., 8, n)) as the
    kernels' MMAs on split operands: big·small, small·big, big·big, each
    summed exactly with the accumulator and rounded toward zero; or one
    TF32 pass (big·big). ``small`` makes the small part from the exact
    remainder: ``tf32_rna`` (the forward) or ``tf32_trunc`` (the
    backward)."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    terms = [(ab, bb)] if passes == 1 else [
        (ab, small(b - bb)), (small(a - ab), bb), (ab, bb)]
    for x, y in terms:
        c = f32_rz(c.double() + x.double() @ y.double())
    return c
