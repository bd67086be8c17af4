"""Wrap a round transport's state + RNG + round cursor into one
checkpoint tree, and hash trees: the JAX ``resilience/state_codec.py``,
format 1.

A resume needs three things: the state (``DiLoCoState`` or
``StreamState``), the generator the rounds draw their tokens from as it
stood at the cut, and the rounds already done (the drop and active masks
are indexed by round, the data by the generator). ``wrap``/``unwrap``
bundle them into a dict that rides ``checkpoint.py`` unchanged. Where the
JAX envelope holds the host ``jax.random`` key ((2,) uint32) under
``rng/key``, the port's holds the ``torch.Generator``'s ``get_state()``
bytes (uint8): the ``state`` subtrees of the two packages cross-load, the
envelopes do not.

``tree_sha256`` is the bit-identity gate: a digest over every leaf's
path, dtype, shape and raw bytes, sorted by path. Paths are rendered as
``jax.tree_util.keystr`` renders them (``['key']``, ``.field``, ``[i]``),
bf16 leaves hash as their uint16 bits and host ints as int32, so a port
state hashes as the JAX package's ``tree_sha256`` of the same state.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import tree
from ..checkpoint.checkpoint import _host

_FORMAT = 1


def wrap(state, gen, rounds_done: int) -> dict:
    """Bundle (state, the generator's state, the rounds-done cursor) into
    the checkpointable envelope. ``gen``: a ``torch.Generator`` or its
    ``get_state()`` bytes."""
    key = gen.get_state() if isinstance(gen, torch.Generator) else gen
    return {
        "state": state,
        "rng": {"key": np.asarray(key, np.uint8).copy()},
        "cursor": {"rounds_done": np.int32(rounds_done),
                   "format": np.int32(_FORMAT)},
    }


def unwrap(t: dict):
    """Inverse of ``wrap``: (state, generator state as a uint8 CPU
    tensor, for ``Generator.set_state``, rounds_done)."""
    fmt = int(np.asarray(t["cursor"]["format"]))
    if fmt != _FORMAT:
        raise ValueError(
            f"checkpoint envelope format {fmt} != supported {_FORMAT}")
    key = torch.from_numpy(np.asarray(t["rng"]["key"], np.uint8).copy())
    return t["state"], key, int(np.asarray(t["cursor"]["rounds_done"]))


def keystr(path) -> str:
    """A ``tree.flatten_with_path`` path as ``jax.tree_util.keystr``."""
    return "".join(f"[{name!r}]" if kind == "key" else
                   f".{name}" if kind == "attr" else f"[{name}]"
                   for kind, name in path)


def _leaf_bytes(x) -> tuple:
    """(dtype string, shape, raw bytes as a uint8 view) of one leaf."""
    a = _host(x)[0]
    return a.dtype.str, a.shape, np.ascontiguousarray(a).reshape(-1).view(
        np.uint8)


def _fold(h, dstr: str, shape: tuple, raw: bytes):
    h.update(dstr.encode())
    h.update(repr(shape).encode())
    h.update(raw)
    return h


def leaf_hashes(t) -> dict:
    """Per-leaf sha256 digests keyed by path: which leaf made two runs'
    ``tree_sha256`` disagree."""
    return {keystr(path): _fold(hashlib.sha256(),
                                *_leaf_bytes(leaf)).hexdigest()
            for path, leaf in tree.flatten_with_path(t)}


def tree_sha256(t) -> str:
    """Digest of a tree: every leaf's path, dtype, shape and raw bytes
    folded into one sha256, sorted by path."""
    items = sorted(((keystr(path), _leaf_bytes(leaf))
                    for path, leaf in tree.flatten_with_path(t)),
                   key=lambda item: item[0])
    h = hashlib.sha256()
    for path, leaf_bytes in items:
        h.update(path.encode())
        _fold(h, *leaf_bytes)
    return h.hexdigest()
