"""AdamW inner optimizer (the JAX ``optim/adamw.py``), in place.

Decoupled weight decay, bias-corrected moments; ``init`` then ``update``.
Under a mixed precision policy (``optim/precision.py``) the state also
carries a float32 master copy of the params; the moments and the working
params ride at bfloat16.
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
from ..kernels.ref import device_scalar, f32, sqrt_rn
from ..sharding.spec import is_dtensor, local_blocks
from . import precision


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: int
    # the master copy of the params under a mixed policy, else None
    master: Any = None


def init(params, *, policy: precision.Policy | None = None) -> AdamWState:
    """Zero moments shaped like ``params``, which arrive at master
    precision (the caller's tree). With a ``policy`` the moments are
    allocated at its ``param_dtype``, and a mixed policy also keeps a fresh
    ``master_dtype`` master copy (never an alias of ``params``). Without a
    policy the moments take the params' dtypes."""
    if policy is None:
        zeros = torch.zeros_like
    else:
        zeros = lambda p: torch.zeros_like(p, dtype=policy.param_dtype)
    master = None
    if policy is not None and policy.mixed:
        master = precision.cast_tree(params, policy.master_dtype, fresh=True)
    return AdamWState(m=tree.map(zeros, params), v=tree.map(zeros, params),
                      count=0, master=master)


def master_params(params, state: AdamWState):
    """The authoritative params: the master copy under a mixed policy, the
    working params otherwise."""
    return params if state.master is None else state.master


def update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, mode: str = "auto",
           policy: precision.Policy | None = None):
    """One AdamW step, in place. Returns (params, new_state).

    ``mode`` ``auto``/``kernel`` run the fused kernels over the tree
    (``kernels.ops.adamw_update_tree``, or ``adamw_update_tree_mixed``
    under a mixed policy); ``ref`` runs the JAX package's ``ref``-mode
    maths, in its operation order (it squares g first, where the kernels
    multiply (1-b2)*g by g). The maths is float32 whatever the storage
    dtype; under a mixed policy it reads and writes the state's master
    copy and rounds the new working params (``params``) from it.
    """
    count = state.count + 1
    mixed = policy is not None and policy.mixed
    if state.master is not None and not mixed:
        # going on would drop (or desync) the master and train from the
        # rounded working copy
        raise ValueError(
            "state carries a master copy but no mixed policy was passed: "
            "thread the same precision policy through init and update")
    if mixed and state.master is None:
        raise ValueError(
            "mixed-policy update needs a master copy in the state: build "
            "it with adamw.init(params, policy=policy)")
    # an island's DTensors (each leaf's param, grad and moments in one
    # layout) are updated on each rank's blocks, as they lie: AdamW is
    # elementwise; the returned params are the DTensors, updated in place
    trees = (params, grads, state.m, state.v) + (
        (state.master,) if mixed else ())
    blocks = [local_blocks(*ls) for ls in zip(*map(tree.leaves, trees))]
    local = [tree.unflatten(t, [b[i] for b in blocks])
             for i, t in enumerate(trees)]
    first = blocks[0][0]
    hp = dict(lr=lr, count=count, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay, mode=mode)
    if ops._resolve(mode, first):
        if mixed:
            ops.adamw_update_tree_mixed(*local, **hp)
        else:
            ops.adamw_update_tree(*local, **hp)
        return params, state._replace(count=count)
    c1, c2 = ops.adamw_scalars(count, b1, b2)
    c1t, c2t = device_scalar(c1, first), device_scalar(c2, first)
    with torch.no_grad():
        for p, g, m, v, *w in blocks:
            w = w[0] if w else None
            gf = g.float()
            wf = (p if w is None else w).float()
            m_new = f32(b1) * m.float() + f32(1.0 - b1) * gf
            v_new = f32(b2) * v.float() + f32(1.0 - b2) * torch.square(gf)
            mhat = m_new / c1t
            vhat = v_new / c2t
            step = mhat / (sqrt_rn(vhat) + f32(eps)) \
                + f32(weight_decay) * wf
            w_new = wf - f32(lr) * step
            # copy_ rounds each result to its storage dtype
            p.copy_(w_new)
            m.copy_(m_new)
            v.copy_(v_new)
            if w is not None:
                w.copy_(w_new)
    return params, state._replace(count=count)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the grads (in place) so their global L2 norm is at most
    ``max_norm``. The norm and the products are float32 whatever the
    grads' dtype, and bf16 grads are rounded back to bf16 once. Returns
    (grads, norm); norm and scale stay on the device, so no host sync."""
    ls = tree.leaves(grads)
    # on an island's DTensors each leaf's sum of squares is reduced across
    # its shards (``full_tensor``); the scale then applies to every block
    sq = [torch.sum(torch.square(g.float())) for g in ls]
    sq = [s.full_tensor() if is_dtensor(s) else s for s in sq]
    ls = [local_blocks(g)[0] for g in ls]
    gn = sqrt_rn(sum(sq))
    # a 0-d numerator: PyTorch computes scalar / tensor as a reciprocal
    # times the scalar, which does not round as the reference's division
    scale = torch.clamp(device_scalar(max_norm, gn) / (gn + f32(1e-12)),
                        max=1.0)
    for g in ls:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            # an in-place bf16 product would round the scale to bf16 first
            g.copy_(g.float() * scale)
    return grads, gn
