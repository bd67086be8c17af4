"""Outer optimizers (Algorithm 1, line 14), as in the JAX
``core/outer_opt.py``; they update θ and their buffers in place.

The outer gradient Δ = θ^(t-1) − mean_i θ_i^(t) is treated as a gradient:
θ^(t) = OuterOpt(θ^(t-1), Δ). Nesterov(lr=0.7, μ=0.9) is the paper's
default; SGD(lr=1) is FedAvg; Adam needs eps≈0.1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tree
from ..kernels import ops
from ..kernels.ref import device_scalar, f32, sqrt_rn


class OuterState(NamedTuple):
    buf: dict          # momentum buffer (or Adam m)
    buf2: dict         # Adam v (zeros otherwise)
    count: int         # host integer


def init(params) -> OuterState:
    z = lambda p: torch.zeros_like(p)
    return OuterState(tree.map(z, params), tree.map(z, params), 0)


def update(delta, state: OuterState, params, *, kind: str, lr: float,
           momentum: float = 0.9, b2: float = 0.95, eps: float = 0.1,
           kernel_mode: str = "auto"):
    """One outer step, in place on ``params`` and the state's buffers.
    Returns (params, new_state).

    ``kernel_mode`` auto/kernel run the Nesterov update (the paper's
    default) through the fused kernel; the other kinds, and ``ref``, are
    the JAX package's tree maps in its operation order."""
    count = state.count + 1
    ps = tree.leaves(params)
    use_kernel = ops._resolve(kernel_mode, ps[0])
    if kind == "nesterov" and use_kernel:
        ops.nesterov_update_tree(params, delta, state.buf, lr=lr,
                                 momentum=momentum, mode=kernel_mode)
        return params, OuterState(state.buf, state.buf2, count)

    ds, bs, b2s = tree.leaves(delta), tree.leaves(state.buf), \
        tree.leaves(state.buf2)
    lr, mu = f32(lr), f32(momentum)
    with torch.no_grad():
        if kind == "sgd":
            for p, d in zip(ps, ds):
                p.copy_(p - lr * d)
        elif kind == "sgdm":
            for p, d, b in zip(ps, ds, bs):
                b.copy_(mu * b + d)
                p.copy_(p - lr * b)
        elif kind == "nesterov":
            for p, d, b in zip(ps, ds, bs):
                b.copy_(mu * b + d)
                p.copy_(p - lr * (mu * b + d))
        elif kind == "adam":
            c1, c2 = ops.adamw_scalars(count, momentum, b2)
            c1t, c2t = device_scalar(c1, ps[0]), device_scalar(c2, ps[0])
            for p, d, m, v in zip(ps, ds, bs, b2s):
                m.copy_(mu * m + f32(1 - momentum) * d)
                v.copy_(f32(b2) * v + f32(1 - b2) * d * d)
                p.copy_(p - lr * (m / c1t) / (sqrt_rn(v / c2t)
                                              + f32(eps)))
        else:
            raise ValueError(kind)
    return params, OuterState(state.buf, state.buf2, count)
