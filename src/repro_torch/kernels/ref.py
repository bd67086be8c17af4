"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same
operation order, so that the kernel agrees with it bit for bit on the
card. They are what the kernel wrappers run on CPU tensors, what the CPU
tests hold against the JAX package's ``kernels/ref.py``, and what
``chip_smoke.py`` holds the kernels against.

Scalars are rounded to float32 once (as JAX's weak typing does) and the
divisors are 0-d tensors on the operands' device: PyTorch turns a
division by a Python scalar on CUDA into a multiplication by its
reciprocal, which would not round as the kernel's IEEE division does.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float32, as a 0-d tensor on ``like``'s device. Made
    by a fill on the device: a copy from the host would wait for the
    device's queue to drain."""
    return torch.full((), f32(x), dtype=torch.float32, device=like.device)


def fused_adamw(p, g, m, v, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1, c1=1.0, c2=1.0):
    """One AdamW step on one float32 tensor; returns new (p, m, v).

    The order of ``_adamw_kernel`` (src/repro/kernels/fused_adamw.py):
    the JAX oracle squares g first, the kernel multiplies (1-b2)*g by g.
    """
    c1t, c2t = device_scalar(c1, p), device_scalar(c2, p)
    m_new = f32(b1) * m + f32(1.0 - b1) * g
    v_new = f32(b2) * v + f32(1.0 - b2) * g * g
    step = (m_new / c1t) / (torch.sqrt(v_new / c2t) + f32(eps)) \
        + f32(weight_decay) * p
    p_new = p - f32(lr) * step
    return p_new, m_new, v_new


def outer_nesterov(p, delta, buf, *, lr, momentum=0.9):
    """θ ← θ − lr·(μ·b_new + Δ) with b_new = μ·b + Δ. Returns (p, buf)."""
    mu = f32(momentum)
    b_new = mu * buf + delta
    p_new = p - f32(lr) * (mu * b_new + delta)
    return p_new, b_new
