"""Outer-gradient compression (paper §6.2, Table 6), as the JAX
``core/compression.py``.

Per-neuron sign pruning following the TIES heuristic (Yadav et al. 2023):
for each neuron (row of a weight matrix) elect the dominant sign by total
magnitude mass, then prune, within that row, the entries that disagree
with the elected sign or fall in the smallest-magnitude ``frac``
quantile. The paper finds that pruning 50% of the outer-gradient values
costs +0.39% perplexity.

The pruning writes over its input (the outer step owns its fresh deltas).
On CUDA tensors it runs the CUDA kernels of ``kernels/csrc/sign_prune.cu``;
on CPU tensors their plain version.
"""
from __future__ import annotations

import torch

from .. import tree
from ..kernels import ops as kops


def sign_prune_matrix(x, frac: float, *, mode: str = "auto"):
    """x: (R, C), pruned per row in place (returned)."""
    return kops.sign_prune(x, frac, mode=mode)


def sign_prune(params, frac: float, *, mode: str = "auto",
               stacked: bool = False):
    """Per-neuron sign pruning of every leaf of an outer-gradient tree, in
    place (the tree is returned). Leaves are pruned as (leading dim, the
    rest flattened), a 'neuron' being one output row; vectors prune as one
    row. ``stacked=True`` prunes each replica of (k, ...) leaves by that
    rule, in one pass per leaf (see ``kernels.ops.sign_prune_tree``)."""
    return kops.sign_prune_tree(params, frac, mode=mode, stacked=stacked)


def density(params) -> torch.Tensor:
    """Fraction of non-zero entries: the achieved compression ratio (a 0-d
    device tensor)."""
    ls = tree.leaves(params)
    nz = sum(torch.count_nonzero(t) for t in ls)
    return nz / sum(t.numel() for t in ls)
