"""AdamW inner optimizer (the JAX ``optim/adamw.py``), in place.

Decoupled weight decay, bias-corrected moments; ``init`` then ``update``.
``update`` writes the new params and moments over the old ones (the
counterpart of the JAX driver donating them) and returns the same dicts.
The step counter is a host integer: it feeds the float32 bias-correction
scalars that the kernel takes by value, so it costs no device sync.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import tree
from ..kernels import ops
from ..kernels.ref import device_scalar, f32
from . import precision


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: int
    # a mixed policy's master copy; always None in this slice
    master: Any = None


def init(params, *, policy: precision.Policy | None = None) -> AdamWState:
    """Zero moments shaped like ``params``. Only the float32 policy is
    ported (``precision.make_policy`` rejects the others)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(m=tree.map(zeros, params), v=tree.map(zeros, params),
                      count=0)


def master_params(params, state: AdamWState):
    """The authoritative params: the master copy under a mixed policy
    (not ported), the working params otherwise."""
    return params if state.master is None else state.master


def update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, mode: str = "auto",
           policy: precision.Policy | None = None):
    """One AdamW step, in place. Returns (params, new_state).

    ``mode`` ``auto``/``kernel`` run the fused kernel over the tree
    (``kernels.ops.adamw_update_tree``); ``ref`` runs the JAX package's
    legacy tree map, in its operation order (it squares g first, where
    the kernel multiplies (1-b2)*g by g).
    """
    if state.master is not None or (policy is not None and policy.mixed):
        raise NotImplementedError(
            "mixed-precision AdamW is not ported yet (ROADMAP.md, port "
            "queue: mixed-precision policy)")
    count = state.count + 1
    first = tree.leaves(params)[0]
    if ops._resolve(mode, first):
        ops.adamw_update_tree(params, grads, state.m, state.v, lr=lr,
                              count=count, b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay, mode=mode)
        return params, AdamWState(state.m, state.v, count)
    c1, c2 = ops.adamw_scalars(count, b1, b2)
    c1t, c2t = device_scalar(c1, first), device_scalar(c2, first)
    with torch.no_grad():
        for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                              tree.leaves(state.m), tree.leaves(state.v)):
            m_new = f32(b1) * m + f32(1.0 - b1) * g
            v_new = f32(b2) * v + f32(1.0 - b2) * torch.square(g)
            mhat = m_new / c1t
            vhat = v_new / c2t
            step = mhat / (torch.sqrt(vhat) + f32(eps)) \
                + f32(weight_decay) * p
            p.copy_(p - f32(lr) * step)
            m.copy_(m_new)
            v.copy_(v_new)
    return params, AdamWState(state.m, state.v, count)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the grads (in place) so their global L2 norm is at most
    ``max_norm``. Returns (grads, norm); norm and scale stay on the
    device, so no host sync."""
    ls = tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in ls))
    # a 0-d numerator: PyTorch computes scalar / tensor as a reciprocal
    # times the scalar, which does not round as the reference's division
    scale = torch.clamp(device_scalar(max_norm, gn) / (gn + f32(1e-12)),
                        max=1.0)
    for g in ls:
        g.mul_(scale)
    return grads, gn
