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

Packed int4 weights (``save_packed``, ``load_packed``, ``unpack_params``,
``restore_packed``) store a parameter tree as the packed wire of its
fragment regions, in the JAX package's format.
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


# ---------------------------------------------------------------------------
# packed int4 weights: the wire codec at rest (the JAX package's format)
# ---------------------------------------------------------------------------

_MANIFEST_KEY = "__packed_manifest__"
PACKED_FORMAT = "diloco_packed_weights_v1"


def _region_key(p: int, j: int) -> str:
    return f"frag{p}{_SEP}reg{j}"


def _leaf_paths(t) -> tuple:
    flat = tree.flatten_with_path(t)
    return [key_of(p) for p, _ in flat], [x for _, x in flat]


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_packed(path: str, params, *, n_fragments: int = 4,
                dtype: str = "int4", mode: str = "auto",
                metadata: dict | None = None) -> dict:
    """Save ``params`` as packed wire buffers, one per fragment region, in
    the JAX ``save_packed`` file format (a file written by one package
    loads in the other).

    For each of the ``n_fragments`` contiguous fragments (the streaming
    outer sync's partition) each contiguous region is flattened and
    ``ops.wire_encode``d (int4 on CUDA tensors: one ``quantize_pack_int4``
    launch a region); the npz holds one uint8 buffer per region and a json
    manifest (leaf paths, shapes, dtypes and the region table) under
    ``__packed_manifest__``. Returns the manifest."""
    from ..core import fragments
    from ..kernels import ops
    paths, leaves = _leaf_paths(params)
    part = fragments.partition_params(params, n_fragments)
    regions = fragments.fragment_regions(part, params)
    arrays: dict = {}
    man_frags = []
    for p, regs in enumerate(regions):
        rr = []
        for j, r in enumerate(regs):
            flat = fragments.region_take(leaves[r.leaf].float(), r)
            wire, _ = ops.wire_encode(flat, dtype, mode=mode,
                                      with_local=False)
            arrays[_region_key(p, j)] = _host(wire)[0]
            rr.append([r.leaf, r.start, r.stop, r.elems])
        man_frags.append(rr)
    manifest = {
        "format": PACKED_FORMAT,
        "dtype": dtype,
        "n_fragments": part.n,
        "leaf_paths": paths,
        "leaf_shapes": [list(_shape(x)) for x in leaves],
        "leaf_dtypes": [_dtype_name(x) for x in leaves],
        "fragments": man_frags,
        "packed_bytes": int(sum(a.nbytes for a in arrays.values())),
        "f32_bytes": int(sum(int(np.prod(_shape(x)) or 1) * 4
                             for x in leaves)),
    }
    arrays[_MANIFEST_KEY] = np.asarray(json.dumps(manifest))
    _atomic_write(path, lambda f: np.savez(f, **arrays))
    if metadata is not None:
        atomic_write_json(path + ".meta.json", metadata, indent=2,
                          default=str)
    return manifest


def _check_structure(manifest, example_tree) -> list:
    paths, leaves = _leaf_paths(example_tree)
    if paths != list(manifest["leaf_paths"]):
        raise KeyError(
            "packed checkpoint structure mismatch: "
            f"ckpt leaves {manifest['leaf_paths'][:3]}... vs example "
            f"{paths[:3]}...")
    for p, x, s in zip(paths, leaves, manifest["leaf_shapes"]):
        if _shape(x) != tuple(s):
            raise ValueError(f"shape mismatch for {p}: ckpt {tuple(s)} vs "
                             f"example {_shape(x)}")
    return leaves


def load_packed(path: str) -> dict:
    """The raw packed checkpoint: ``{"manifest": ..., "buffers":
    {region key: uint8 numpy array}}``. The buffers stay packed: a server
    decodes them at each use (``unpack_params``)."""
    with np.load(path) as data:
        if _MANIFEST_KEY not in data.files:
            raise KeyError(f"{path} is not a packed checkpoint "
                           f"(missing {_MANIFEST_KEY})")
        manifest = json.loads(str(data[_MANIFEST_KEY]))
        buffers = {k: data[k] for k in data.files if k != _MANIFEST_KEY}
    return {"manifest": manifest, "buffers": buffers}


def _unpacked(manifest, example_tree, wire_of, *, mode: str, device):
    """The dequantized param tree, each region decoded from ``wire_of(p,
    j)`` (a uint8 tensor on ``device``) straight into its place."""
    from ..core import fragments
    from ..kernels import ops
    leaves = _check_structure(manifest, example_tree)
    dts = [getattr(x, "dtype", torch.float32) for x in leaves]
    dts = [d if isinstance(d, torch.dtype) else torch.float32 for d in dts]
    covered = sum(r[3] for regs in manifest["fragments"] for r in regs)
    whole = covered == sum(int(np.prod(_shape(x))) for x in leaves)
    new = torch.empty if whole else torch.zeros
    out = [new(_shape(x), dtype=d, device=device)
           for x, d in zip(leaves, dts)]
    for p, regs in enumerate(manifest["fragments"]):
        for j, (leaf_i, start, stop, elems) in enumerate(regs):
            r = fragments.Region(leaf_i, start, stop, elems)
            dst = fragments.region_take(out[leaf_i], r)
            if dst.dtype == torch.float32 and dst.is_contiguous():
                ops.wire_decode(wire_of(p, j), elems, manifest["dtype"],
                                mode=mode, out=dst)
            else:
                fragments.region_put(out[leaf_i], r, ops.wire_decode(
                    wire_of(p, j), elems, manifest["dtype"], mode=mode))
    return tree.unflatten_like(example_tree, out)


def unpack_params(buffers, manifest, example_tree, *, mode: str = "auto"):
    """The (dequantized f32) param tree of packed ``buffers`` (region key
    -> uint8 tensor, all on one device; the tree is built there).
    ``example_tree`` supplies structure and shapes only (tensors on the
    ``meta`` device do). Int4 on CUDA tensors: one
    ``unpack_dequantize_int4`` launch a region, decoding in place."""
    device = next(iter(buffers.values())).device
    return _unpacked(manifest, example_tree,
                     lambda p, j: buffers[_region_key(p, j)], mode=mode,
                     device=device)


def restore_packed(path: str, example_tree, *, mode: str = "auto",
                   device="cpu"):
    """A packed checkpoint restored to a dequantized f32 param tree on
    ``device``, region by region (the npz loads each key lazily: the
    extra host memory is one region's wire buffer)."""
    with np.load(path) as data:
        if _MANIFEST_KEY not in data.files:
            raise KeyError(f"{path} is not a packed checkpoint "
                           f"(missing {_MANIFEST_KEY})")
        manifest = json.loads(str(data[_MANIFEST_KEY]))
        return _unpacked(
            manifest, example_tree,
            lambda p, j: torch.from_numpy(
                data[_region_key(p, j)]).to(device), mode=mode,
            device=device)
