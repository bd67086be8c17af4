"""Replica-state precision policy (the JAX ``optim/precision.py``).

  param_dtype   storage dtype of the replica-side state: the working
                params the forward and backward run on, and the AdamW
                moments;
  master_dtype  storage dtype of the master-side state. When it is wider
                than ``param_dtype``, each replica's AdamW state carries
                a master copy of the params at this dtype: the update
                reads it, writes it back and emits the working copy, and
                the outer deltas are taken master against master.

The three policies:

  (float32, float32)    the default: no master copy (12 B/param/replica
                        of params and moments);
  (bfloat16, float32)   the mixed policy: bf16 working params and
                        moments plus an f32 master (10 B/param/replica);
  (bfloat16, bfloat16)  pure bf16 replica state, no master; the update
                        still computes in f32 (6 B/param/replica).

The global params and the outer optimizer's buffers stay float32 under
every policy: they exist once, not k times.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tree

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_WIDTH = {"float32": 4, "bfloat16": 2}


class Policy(NamedTuple):
    param_dtype: torch.dtype
    master_dtype: torch.dtype

    @property
    def mixed(self) -> bool:
        return self.param_dtype != self.master_dtype


def make_policy(param_dtype: str = "float32",
                master_dtype: str = "float32") -> Policy:
    for name, val in (("param_dtype", param_dtype),
                      ("master_dtype", master_dtype)):
        if val not in DTYPES:
            raise ValueError(
                f"{name} must be one of {sorted(DTYPES)}, got {val!r}")
    if _WIDTH[master_dtype] < _WIDTH[param_dtype]:
        raise ValueError(
            f"master_dtype ({master_dtype}) must be at least as wide as "
            f"param_dtype ({param_dtype})")
    return Policy(DTYPES[param_dtype], DTYPES[master_dtype])


def policy_of(cfg) -> Policy:
    """The policy of a TrainConfig / DiLoCoConfig."""
    return make_policy(getattr(cfg, "param_dtype", "float32"),
                       getattr(cfg, "master_dtype", "float32"))


def cast_tree(params, dtype, *, fresh: bool = False):
    """Every leaf cast to ``dtype``; ``fresh=True`` copies even when the
    cast is the identity."""
    return tree.map(lambda x: x.to(dtype, copy=fresh), params)


def tree_bytes(params) -> int:
    """Total storage bytes of a tree's leaves (None-safe)."""
    if params is None:
        return 0
    return int(sum(t.numel() * t.element_size() for t in tree.leaves(params)))
