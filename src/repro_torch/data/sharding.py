"""Data-shard assignment (the JAX ``data/sharding.py``): i.i.d. vs
non-i.i.d. regimes (paper §3.1).

The paper builds non-i.i.d. shards by k-Means clustering C4 documents on a
pretrained model's features, which yields (a) distinct per-shard
distributions and (b) *imbalanced* shard sizes (they weight outer grads by
shard size at k=64). We model both: ``make_regime`` returns a sampler
whose shards have controllable distribution skew (alpha) and a size
profile (balanced or Zipf-imbalanced, mirroring cluster imbalance).
"""
from __future__ import annotations

import numpy as np

from .pipeline import MarkovMixture


def make_regime(regime: str, *, k: int = 8, vocab_size: int = 256,
                seed: int = 0, alpha_noniid: float = 2.0,
                imbalanced: bool = False, device) -> MarkovMixture:
    if regime not in ("iid", "non_iid"):
        raise ValueError(f"regime must be 'iid' or 'non_iid', got {regime!r}")
    alpha = 0.0 if regime == "iid" else alpha_noniid
    if imbalanced:
        sizes = 1.0 / np.arange(1, k + 1, dtype=np.float32)  # Zipf profile
        sizes = sizes / sizes.sum() * k
    else:
        sizes = np.ones((k,), np.float32)
    return MarkovMixture(vocab_size=vocab_size, k=k, alpha=alpha,
                         seed=seed, shard_sizes=sizes, device=device)


def shard_weights(sampler: MarkovMixture, weighted: bool) -> np.ndarray:
    """Outer-gradient averaging weights (uniform, or by shard size)."""
    if weighted:
        w = sampler.shard_sizes
    else:
        w = np.ones((sampler.k,), np.float32)
    return (w / w.sum()).astype(np.float32)
