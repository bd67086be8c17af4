"""Replica-state precision policy (the JAX ``optim/precision.py``).

This slice ports the (float32, float32) policy only: every replica leaf
and AdamW moment is float32 and no master copy is carried. The mixed
(bfloat16, float32) and pure (bfloat16, bfloat16) policies need the
mixed-precision AdamW kernel, which is not ported yet; asking for them
raises.
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
    if (param_dtype, master_dtype) != ("float32", "float32"):
        raise NotImplementedError(
            f"precision policy ({param_dtype}, {master_dtype}) is not "
            "ported yet: the port runs float32 replicas only (ROADMAP.md, "
            "port queue: mixed-precision policy)")
    return Policy(DTYPES[param_dtype], DTYPES[master_dtype])


def policy_of(cfg) -> Policy:
    """The policy of a TrainConfig / DiLoCoConfig."""
    return make_policy(getattr(cfg, "param_dtype", "float32"),
                       getattr(cfg, "master_dtype", "float32"))


def cast_tree(params, dtype, *, fresh: bool = False):
    """Every leaf cast to ``dtype``; ``fresh=True`` copies even when the
    cast is the identity."""
    return tree.map(lambda x: x.to(dtype, copy=fresh), params)
