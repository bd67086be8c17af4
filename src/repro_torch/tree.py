"""Nested-dict trees of tensors, flattened in the JAX tree order.

``jax.tree`` flattens a dict in sorted-key order. Sums over a tree's
leaves (the global grad norm, the outer-gradient norm) are taken in that
order here too, so the port adds the same terms in the same sequence as
the reference.

``flatten_with_path`` and ``unflatten_like`` also walk the NamedTuple
states, tuples, lists and None (no leaves) as ``jax.tree_util`` does; a
path is a tuple of ("key", dict key), ("attr", field name) and ("idx",
position) entries, which the checkpoint files and the state hashes render
as the JAX package does.
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


def _children(t):
    """[(path entry, child), ...] of an inner node, or None for a leaf."""
    if isinstance(t, dict):
        return [(("key", k), t[k]) for k in sorted(t)]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return [(("attr", f), getattr(t, f)) for f in t._fields]
    if isinstance(t, (tuple, list)):
        return [(("idx", i), x) for i, x in enumerate(t)]
    return None


def flatten_with_path(t, prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]`` of dicts, NamedTuples, tuples and lists in
    the ``jax.tree_util`` order; None holds no leaf."""
    if t is None:
        return []
    kids = _children(t)
    if kids is None:
        return [(prefix, t)]
    return [pl for entry, x in kids
            for pl in flatten_with_path(x, prefix + (entry,))]


def unflatten_like(example, flat):
    """A tree shaped like ``example`` (dicts, NamedTuples, tuples, lists,
    None) holding ``flat`` in ``flatten_with_path`` order."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(example)
