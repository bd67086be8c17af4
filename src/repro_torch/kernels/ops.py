"""Backend dispatch for the port's kernels, and their tree-level forms.

``kernel_mode`` (TrainConfig / DiLoCoConfig):

  auto    the kernel wrapper: the CUDA kernel on CUDA tensors, its plain
          PyTorch version on CPU tensors (the default);
  kernel  the CUDA kernel, or an error on CPU tensors;
  ref     the plain PyTorch version, whatever the device.

The JAX package's ``pallas`` and ``interpret`` modes name TPU machinery
and have no counterpart here: they are rejected.

The tree-level updates write their outputs over their inputs (θ, m, v and
θ, buffer): the counterpart of the JAX driver donating the state.
"""
from __future__ import annotations

import numpy as np

from .. import tree
from . import flash_attention as _flash
from . import fused_adamw as _adamw
from . import outer_nesterov as _nesterov
from . import ref

MODES = ("auto", "kernel", "ref")


def _resolve(mode: str, like) -> bool:
    """-> use the kernel wrapper (True) or the plain version (False)."""
    if mode in ("pallas", "interpret"):
        raise ValueError(
            f"kernel_mode={mode!r} names TPU (Pallas) machinery, which the "
            "port has no counterpart of: use auto, kernel or ref")
    if mode not in MODES:
        raise ValueError(f"kernel_mode must be one of {MODES}, got {mode!r}")
    if mode == "kernel" and like.device.type != "cuda":
        raise ValueError("kernel_mode='kernel' launches the CUDA kernels and "
                         f"needs CUDA tensors, got {like.device}")
    return mode != "ref"


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    mode: str = "auto"):
    """Differentiable flash attention in the model layout: q (B, S, H, d),
    k/v (B, S, G, d) -> (B, S, H, d). ``auto`` and ``kernel`` go through
    the kernel wrapper (the kernels on CUDA tensors, the plain versions of
    their maths on CPU tensors); ``ref`` is the plain full-softmax
    attention of the JAX ``kernels/ref.py``."""
    if not _resolve(mode, q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    # the kernels read the (B, S, H, d) buffers in place through the
    # transposed views
    out = _flash.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window, scale=scale)
    return out.transpose(1, 2)


def adamw_scalars(count: int, b1: float, b2: float):
    """Bias corrections (c1, c2) = (1 − b1^t, 1 − b2^t) as float32, in the
    expressions of the JAX ``ops.adamw_update_tree``. ``count`` is the
    post-increment step, a host integer: no device sync."""
    cf = np.float32(count)
    one = np.float32(1.0)
    return one - np.float32(b1) ** cf, one - np.float32(b2) ** cf


def adamw_update_tree(params, grads, m, v, *, lr, count, b1=0.9, b2=0.95,
                      eps=1e-8, weight_decay=0.1, mode: str = "auto"):
    """One fused AdamW step over a whole tree, in place: the new params
    and moments are written over ``params``, ``m`` and ``v``, which are
    returned. ``count`` is the post-increment step."""
    c1, c2 = adamw_scalars(count, b1, b2)
    ps = tree.leaves(params)
    use_kernel = _resolve(mode, ps[0])
    for p, g, mm, vv in zip(ps, tree.leaves(grads), tree.leaves(m),
                            tree.leaves(v)):
        if use_kernel:
            _adamw.fused_adamw_(p, g, mm, vv, lr=lr, c1=c1, c2=c2, b1=b1,
                                b2=b2, eps=eps, weight_decay=weight_decay)
        else:
            outs = ref.fused_adamw(p, g, mm, vv, lr=lr, b1=b1, b2=b2,
                                   eps=eps, weight_decay=weight_decay,
                                   c1=c1, c2=c2)
            for dst, src in zip((p, mm, vv), outs):
                dst.copy_(src)
    return params, m, v


def nesterov_update_tree(params, delta, buf, *, lr, momentum=0.9,
                         mode: str = "auto"):
    """One fused outer Nesterov step over a whole tree, in place: the new
    θ and momentum buffer are written over ``params`` and ``buf``, which
    are returned."""
    ps = tree.leaves(params)
    use_kernel = _resolve(mode, ps[0])
    for p, d, b in zip(ps, tree.leaves(delta), tree.leaves(buf)):
        if use_kernel:
            _nesterov.outer_nesterov_(p, d, b, lr=lr, momentum=momentum)
        else:
            new_p, new_b = ref.outer_nesterov(p, d, b, lr=lr,
                                              momentum=momentum)
            p.copy_(new_p)
            b.copy_(new_b)
    return params, buf
