"""Tree checkpointing: flat-key npz arrays + json metadata, in the JAX
``checkpoint/checkpoint.py`` file format.

A tree (dicts, NamedTuple states, tuples, lists; None holds nothing) is
written as one npz entry per leaf, keyed by the leaf's path joined with
``//`` (a dict key or a field name as it is, a position as ``[i]``), so a
file written by either package restores in the other. Writes are atomic
and durable (tmp + fsync + rename, then the directory fsynced).

Leaves: tensors are copied to the host; bfloat16 tensors are written as
their uint16 bit patterns, named ``key=bfloat16`` under the
``__leaf_dtypes__`` entry, as the JAX package writes its bf16 leaves (the
bits are taken through torch's ``view(torch.int16)``: no ml_dtypes).
Python ints (the port's host step counters) are written as int32 0-d
arrays, as JAX keeps them.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import tree

_SEP = "//"
_DTYPES_KEY = "__leaf_dtypes__"


def _segment(entry) -> str:
    kind, name = entry
    return f"[{name}]" if kind == "idx" else str(name)


def key_of(path) -> str:
    """A ``tree.flatten_with_path`` path as its npz key."""
    return _SEP.join(_segment(e) for e in path)


def _host(leaf) -> tuple:
    """(numpy array, true dtype name or None) of one leaf; bfloat16 as its
    uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    if isinstance(leaf, bool):
        return np.asarray(leaf), None
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), None
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, None


def _flatten(t) -> dict:
    """{npz key: numpy array}, plus the ``__leaf_dtypes__`` entry when a
    leaf is bfloat16."""
    flat, names = {}, []
    for path, leaf in tree.flatten_with_path(t):
        key = key_of(path)
        flat[key], dt = _host(leaf)
        if dt is not None:
            names.append(f"{key}={dt}")
    if names:
        flat[_DTYPES_KEY] = np.asarray(names)
    return flat


def _views_of(data) -> dict:
    if _DTYPES_KEY not in data.files:
        return {}
    return dict(s.rsplit("=", 1) for s in data[_DTYPES_KEY].tolist())


def _tensor(arr: np.ndarray, bf16: bool, *, device, dtype=None):
    """A tensor on ``device`` from a stored array; ``bf16``: the array
    holds bfloat16 bits."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")      # a writable copy, 0-d kept
    t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device=device, dtype=dtype or t.dtype)


def _shape(x) -> tuple:
    return tuple(x.shape) if torch.is_tensor(x) else tuple(np.shape(x))


def _fsync_dir(dirname: str) -> None:
    """fsync the directory entry so that the rename itself is durable."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return                      # platform without dir-open
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: str, write) -> None:
    """``write(file)`` into a temporary file in the target's directory,
    flushed and fsynced, then renamed over ``path`` and the directory
    fsynced: a kill at any instant leaves the old file or the new one."""
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(dirname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def atomic_write_json(path: str, payload, **dump_kw) -> None:
    """Durable atomic json write (the npz's tmp + fsync + rename)."""
    text = json.dumps(payload, **dump_kw)
    _atomic_write(path, lambda f: f.write(text.encode()))


def save(path: str, t, metadata: dict | None = None) -> dict:
    """Write ``t`` to ``path`` (and ``metadata`` to ``path.meta.json``).
    Returns {"bytes": of the arrays written, "copy_s": seconds copying
    the leaves to the host, "write_s": seconds writing and syncing}."""
    t0 = time.perf_counter()
    flat = _flatten(t)
    t1 = time.perf_counter()
    _atomic_write(path, lambda f: np.savez(f, **flat))
    if metadata is not None:
        atomic_write_json(path + ".meta.json", metadata, indent=2,
                          default=str)
    return {"bytes": sum(a.nbytes for a in flat.values()),
            "copy_s": t1 - t0, "write_s": time.perf_counter() - t1}


def restore(path: str, example, *, in_place: bool = False):
    """Restore into the structure, dtypes and devices of ``example``.
    Tensor leaves come back on the example leaf's device at its dtype;
    numpy leaves at the example's dtype; Python numbers as such. With
    ``in_place`` the example's tensors are overwritten (``copy_``) and
    returned in the new tree: the port updates its state in place."""
    with np.load(path) as data:
        views = _views_of(data)
        leaves = []
        for p, ex in tree.flatten_with_path(example):
            key = key_of(p)
            if key not in data.files:
                raise KeyError(f"checkpoint missing key {key!r}")
            arr = data[key]
            if tuple(arr.shape) != _shape(ex):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"example {_shape(ex)}")
            if torch.is_tensor(ex):
                bf16 = views.get(key) == "bfloat16" or (
                    ex.dtype == torch.bfloat16 and arr.dtype == np.uint16)
                if in_place:          # host to device in the copy
                    with torch.no_grad():
                        ex.copy_(_tensor(arr, bf16, device="cpu"))
                    leaves.append(ex)
                else:
                    leaves.append(_tensor(arr, bf16, device=ex.device,
                                          dtype=ex.dtype))
            elif isinstance(ex, bool):
                leaves.append(bool(arr))
            elif isinstance(ex, int):
                leaves.append(int(arr))
            elif isinstance(ex, float):
                leaves.append(float(arr))
            else:
                leaves.append(np.asarray(arr, dtype=np.asarray(ex).dtype))
    return tree.unflatten_like(example, leaves)


def restore_tree(path: str, *, device="cpu") -> dict:
    """Structure-free restore: a nested dict straight from the flat keys
    (a position comes back as a ``"[i]"`` key), every leaf a tensor on
    ``device`` (bfloat16 leaves from their bits). For layouts that change
    from run to run, such as the async engine's snapshot table; put a
    subtree back on its real structure with ``reshape_like``."""
    out: dict = {}
    with np.load(path) as data:
        views = _views_of(data)
        for key in data.files:
            if key == _DTYPES_KEY:
                continue
            node = out
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _tensor(data[key], views.get(key) ==
                                      "bfloat16", device=device)
    return out


def reshape_like(t, example):
    """A dicts-only view (``restore_tree``) put on the structure of
    ``example`` (NamedTuples, tuples, lists): a dict key ``"[0]"`` and a
    position 0 give the same flat key, so the leaves move by key. Leaves
    keep the view's dtype (the example supplies structure and shapes);
    where the example holds a Python int, the leaf becomes one, and where
    it holds a numpy array, a numpy array of the example's dtype (the
    port's host counters and masks). The example's tensors may lie on
    the ``meta`` device: only their shapes are read."""
    by_key = {key_of(p): x for p, x in tree.flatten_with_path(t)}
    leaves = []
    for p, ex in tree.flatten_with_path(example):
        key = key_of(p)
        if key not in by_key:
            raise KeyError(f"restored tree missing key {key!r}")
        x = by_key[key]
        if _shape(x) != _shape(ex):
            raise ValueError(f"shape mismatch for {key}: restored "
                             f"{_shape(x)} vs example {_shape(ex)}")
        if isinstance(ex, int) and not isinstance(ex, bool):
            x = int(x)
        elif isinstance(ex, np.ndarray):
            x = np.asarray(x.cpu() if torch.is_tensor(x) else x,
                           dtype=ex.dtype)
        leaves.append(x)
    return tree.unflatten_like(example, leaves)


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)
