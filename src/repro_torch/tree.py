"""Nested-dict trees of tensors, flattened in the JAX tree order.

``jax.tree`` flattens a dict in sorted-key order. Sums over a tree's
leaves (the global grad norm, the outer-gradient norm) are taken in that
order here too, so the port adds the same terms in the same sequence as
the reference.
"""
from __future__ import annotations


def leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key (JAX) order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    return [tree]


def paths(tree, prefix: str = "") -> list:
    """``[(dotted.path, leaf), ...]`` in the order of ``leaves``."""
    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in paths(tree[key], f"{prefix}{key}.")]
    return [(prefix[:-1], tree)]


def unflatten(like, flat):
    """A tree shaped like ``like`` holding ``flat`` (in ``leaves`` order)."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        return next(it)

    return build(like)


def map(fn, tree, *rest):
    """``fn`` applied leaf-wise over trees of the same structure."""
    if isinstance(tree, dict):
        return {key: map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)
