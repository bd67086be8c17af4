"""Durable checkpoint manager: atomic snapshots, integrity manifests,
retention, and a resume picker that falls back past corrupt files (the
JAX ``resilience/manager.py``; the files are the same).

Layout under ``directory``::

    ckpt_00000012.npz                # the snapshot (checkpoint.save)
    ckpt_00000012.npz.manifest.json  # per-entry sha256 over the npz
    ckpt_00000012.npz.meta.json      # optional caller metadata

The manifest hashes each npz entry as stored (dtype, shape, bytes; bf16
leaves as their uint16 bits), so ``verify`` catches truncation, bit rot
and partial writes without an example tree, and a snapshot written by
either package verifies in the other. ``latest_good()`` walks the
snapshots newest to oldest and returns the first that verifies: the
``--resume auto`` picker.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..checkpoint import checkpoint as ckpt

_PAT = re.compile(r"^ckpt_(\d{8})\.npz$")
_MANIFEST_SUFFIX = ".manifest.json"


def _entry_digest(a: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(a.dtype.str.encode())
    h.update(repr(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    return h.hexdigest()


def _npz_entry_hashes(path: str) -> dict:
    """sha256 of every entry's stored dtype, shape and bytes. The entries
    are read in turn and hashed in a thread pool (hashlib releases the
    GIL). Raises on a file that cannot be opened as a zip (a truncated
    header)."""
    with np.load(path) as data, ThreadPoolExecutor(
            max_workers=os.cpu_count() or 1) as pool:
        futures = {name: pool.submit(_entry_digest, data[name])
                   for name in sorted(data.files)}
        return {name: f.result() for name, f in futures.items()}


class CheckpointManager:
    """Versioned snapshots of one run. ``step`` is the round cursor at
    the cut (or the async events done): monotone, the file name's key."""

    def __init__(self, directory: str, *, retain: int = 3):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.directory = str(directory)
        self.retain = int(retain)
        os.makedirs(self.directory, exist_ok=True)

    def path_of(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{int(step):08d}.npz")

    def steps(self) -> list:
        """Every snapshot step on disk, ascending (with a manifest or not:
        an unverifiable snapshot still holds its slot)."""
        return sorted(int(m.group(1)) for m in
                      map(_PAT.match, os.listdir(self.directory)) if m)

    def save(self, step: int, tree, metadata: dict | None = None) -> dict:
        """Atomically write snapshot ``step`` and its manifest, then apply
        retention. Returns ``checkpoint.save``'s bytes and seconds, the
        seconds of the manifest (``manifest_s``) and the path."""
        path = self.path_of(step)
        stats = ckpt.save(path, tree, metadata)
        t0 = time.perf_counter()
        manifest = {"step": int(step), "format": 1,
                    "entries": _npz_entry_hashes(path)}
        ckpt.atomic_write_json(path + _MANIFEST_SUFFIX, manifest,
                               indent=2, sort_keys=True)
        for old in self.steps()[:-self.retain]:
            self.delete(old)
        return {**stats, "manifest_s": time.perf_counter() - t0,
                "path": path}

    def delete(self, step: int) -> None:
        path = self.path_of(step)
        for p in (path, path + _MANIFEST_SUFFIX, path + ".meta.json"):
            if os.path.exists(p):
                os.unlink(p)

    def verify(self, step: int) -> bool:
        """True iff snapshot ``step`` exists, has a manifest, and every
        entry's hash matches it."""
        path = self.path_of(step)
        mpath = path + _MANIFEST_SUFFIX
        if not (os.path.exists(path) and os.path.exists(mpath)):
            return False
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            actual = _npz_entry_hashes(path)
        except (zipfile.BadZipFile, ValueError, KeyError, OSError,
                EOFError):
            return False
        return manifest.get("entries") == actual

    def latest_good(self) -> int | None:
        """The newest snapshot step that verifies; None if none does."""
        return next((s for s in reversed(self.steps()) if self.verify(s)),
                    None)

    def load(self, step: int, example, *, in_place: bool = False):
        """Snapshot ``step`` in the structure, dtypes and devices of
        ``example`` (``checkpoint.restore``)."""
        return ckpt.restore(self.path_of(step), example, in_place=in_place)

    def load_tree(self, step: int, *, device="cpu") -> dict:
        """Structure-free restore (``checkpoint.restore_tree``), for the
        async engine's snapshot table."""
        return ckpt.restore_tree(self.path_of(step), device=device)
