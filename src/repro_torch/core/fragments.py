"""Fragment partitioning and sync scheduling for streaming DiLoCo, as the
JAX ``core/fragments.py``.

Streaming DiLoCo (Douillard et al., 2025) never syncs the whole model at
once: the parameter tree is split into P contiguous fragments (by
transformer-block depth), and each fragment runs its own outer step on a
schedule staggered across the H inner steps of a round.

  * ``partition_params`` splits a tree into P fragments. Block-stacked
    leaves (the ``stack*`` transformer blocks, leading dim = layers) are
    split along their layer dim; the other leaves are ordered
    embedding-first, head-last; the cut points balance element counts.
    ``overrides`` pin whole leaves to a fragment.
  * ``schedule`` is the per-round event list: fragment p sends at inner
    offset p·H/P (offset 0 is the end of the round, so P=1 is the classic
    outer step) and applies the reduced result τ inner steps later,
    possibly in the next round.

Masks are host-side numpy arrays, one per leaf ((L, 1, ..., 1) for an
L-layer stacked leaf, a 0/1 scalar otherwise), as in the JAX package: the
streaming round reads from them which leaves, and which band of layers,
a fragment touches. Paths are matched in the JAX ``keystr`` form, e.g.
``['stack0']['attn']['wq']``, so an override written for the JAX package
pins the same leaves here. A leaf is anything with ``.shape`` (a tensor,
also on the ``meta`` device, or a numpy array).
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple

import numpy as np

from .. import tree

STACK_PATTERN = r"stack"
EMBED_PATTERN = r"embed"


class Partition(NamedTuple):
    """P disjoint fragments of a parameter tree.

    masks: P trees shaped like the params, each leaf a float32 numpy array
    broadcastable against the param leaf; summed over the fragments they
    are one everywhere. sizes: per-fragment element counts. region_sizes:
    per fragment, the element counts of the contiguous per-leaf regions it
    touches (a stacked leaf's layer band, or a whole other leaf), the unit
    on which the wire accounting charges int4's per-block scales."""
    n: int
    masks: tuple
    sizes: tuple
    region_sizes: tuple = ()

    def peak_fragment_elems(self) -> int:
        return max(self.sizes) if self.sizes else 0


def keystr(keys) -> str:
    """A dict key path in the JAX ``keystr`` form: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in keys)


def key_paths(params, prefix=()) -> list:
    """``[(key tuple, leaf), ...]`` in ``tree.leaves`` order."""
    if isinstance(params, dict):
        return [kp for key in sorted(params)
                for kp in key_paths(params[key], prefix + (key,))]
    return [(prefix, params)]


def _size(leaf) -> int:
    return math.prod(tuple(leaf.shape))


def _is_stacked(path: str, leaf, stack_pattern: str) -> bool:
    return (re.search(stack_pattern, path) is not None
            and len(leaf.shape) >= 1 and leaf.shape[0] > 1)


def partition_params(params, n_fragments: int, *, overrides=(),
                     stack_pattern: str = STACK_PATTERN) -> Partition:
    """Split ``params`` into ``n_fragments`` contiguous fragments.

    Every (leaf, layer) unit gets a depth in [0, 1]: embedding-like leaves
    0, layer j of an L-layer stacked leaf (j + 0.5)/L, the other leaves
    (final norm, head) 1. Units sorted by depth are cut into P groups
    balanced by element count. ``overrides``, ((path-regex, fragment),
    ...) with the first match winning, pin whole leaves."""
    P = int(n_fragments)
    if P < 1:
        raise ValueError(f"n_fragments must be >= 1, got {P}")
    flat = key_paths(params)
    paths = [keystr(keys) for keys, _ in flat]
    leaves = [leaf for _, leaf in flat]

    def forced_fragment(path: str):
        for pat, frag in overrides:
            if re.search(pat, path):
                frag = int(frag)
                if not 0 <= frag < P:
                    raise ValueError(
                        f"override {pat!r} -> fragment {frag} out of "
                        f"range for P={P}")
                return frag
        return None

    # units: (depth, size, leaf index, layer index | None, forced | None)
    units = []
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        forced = forced_fragment(path)
        if _is_stacked(path, leaf, stack_pattern):
            L = leaf.shape[0]
            per = _size(leaf) // L
            for j in range(L):
                units.append(((j + 0.5) / L, per, i, j, forced))
        else:
            depth = 0.0 if re.search(EMBED_PATTERN, path) else 1.0
            units.append((depth, _size(leaf), i, None, forced))
    units.sort(key=lambda u: u[0])          # stable: ties keep order

    free_total = sum(u[1] for u in units if u[4] is None) or 1
    assign = {}
    cum = 0
    for _, size, i, j, forced in units:
        if forced is not None:
            assign[(i, j)] = forced
        else:
            assign[(i, j)] = min(P - 1,
                                 int(P * (cum + 0.5 * size) / free_total))
            cum += size

    mask_leaves: list[list] = [[] for _ in range(P)]
    sizes = [0] * P
    regions: list[list] = [[] for _ in range(P)]
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        if _is_stacked(path, leaf, stack_pattern):
            L = leaf.shape[0]
            per = _size(leaf) // L
            vec = np.zeros((P, L), np.float32)
            for j in range(L):
                f = assign[(i, j)]
                vec[f, j] = 1.0
                sizes[f] += per
            shape = (L,) + (1,) * (len(leaf.shape) - 1)
            for p in range(P):
                mask_leaves[p].append(vec[p].reshape(shape))
                layers = int(vec[p].sum())
                if layers:
                    regions[p].append(layers * per)
        else:
            f = assign[(i, None)]
            sizes[f] += _size(leaf)
            regions[f].append(_size(leaf))
            for p in range(P):
                mask_leaves[p].append(np.float32(1.0 if p == f else 0.0))
    masks = tuple(tree.unflatten(params, mask_leaves[p]) for p in range(P))
    return Partition(P, masks, tuple(sizes),
                     tuple(tuple(r) for r in regions))


# ---------------------------------------------------------------------------
# contiguous region index
# ---------------------------------------------------------------------------

class Region(NamedTuple):
    """One contiguous piece of a fragment: the layer band [start, stop) of
    a stacked leaf, or a whole other leaf (start is None). ``elems``
    counts its elements without any leading replica dim."""
    leaf: int
    start: int | None
    stop: int | None
    elems: int


def fragment_regions(part: Partition, params) -> tuple:
    """Per fragment, the ordered ``Region`` list its masks cover, read
    from the masks. Region order and sizes match ``part.region_sizes``
    (checked)."""
    leaves = tree.leaves(params)
    out = []
    for p in range(part.n):
        regs = []
        for i, (mk, leaf) in enumerate(zip(tree.leaves(part.masks[p]),
                                           leaves)):
            mk = np.asarray(mk)
            if mk.ndim == 0:
                if mk:
                    regs.append(Region(i, None, None, _size(leaf)))
                continue
            idx = np.nonzero(mk.reshape(-1))[0]
            if not idx.size:
                continue
            s, e = int(idx[0]), int(idx[-1]) + 1
            if idx.size != e - s:
                raise ValueError(
                    f"fragment {p} leaf {i}: non-contiguous layer band "
                    f"{idx.tolist()}")
            per = _size(leaf) // int(leaf.shape[0])
            regs.append(Region(i, s, e, (e - s) * per))
        if tuple(r.elems for r in regs) != tuple(part.region_sizes[p]):
            raise AssertionError(
                f"fragment {p}: region index {[r.elems for r in regs]} "
                f"disagrees with region_sizes {part.region_sizes[p]}")
        out.append(tuple(regs))
    return tuple(out)


def region_take(leaf, region: Region, lead_axes: int = 0):
    """``region`` sliced out of ``leaf`` (which may carry ``lead_axes``
    leading replica dims), flattened to (*lead, elems): a view where the
    slice is contiguous."""
    if region.start is not None:
        leaf = leaf[(slice(None),) * lead_axes
                    + (slice(region.start, region.stop),)]
    return leaf.reshape(tuple(leaf.shape[:lead_axes]) + (-1,))


def region_put(leaf, region: Region, flat, lead_axes: int = 0):
    """Inverse of ``region_take``: writes the flat region values into
    ``leaf`` in place (cast to its dtype) and returns it."""
    if region.start is None:
        dst = leaf
    else:
        dst = leaf[(slice(None),) * lead_axes
                   + (slice(region.start, region.stop),)]
    dst.copy_(flat.reshape(dst.shape))
    return leaf


# ---------------------------------------------------------------------------
# per-round sync schedule
# ---------------------------------------------------------------------------

class StreamEvent(NamedTuple):
    kind: str          # "send" | "apply"
    fragment: int
    wrapped: bool      # apply deferred from the previous round's send


class StreamSchedule(NamedTuple):
    """Static per-round plan: ``phases`` is a tuple of (inner_steps,
    events) pairs covering the round (run that many inner steps, then
    fire the events in order); the step counts sum to H."""
    n_fragments: int
    H: int
    tau: int
    send_offsets: tuple    # per fragment, in (0, H]
    apply_offsets: tuple   # per fragment, send + tau (> H: next round)
    phases: tuple


def schedule(n_fragments: int, H: int, tau: int = 0) -> StreamSchedule:
    """The staggered fragment schedule of one round. Fragment p sends
    after p·H/P inner steps (offset 0 maps to H, the end of the round) and
    applies τ steps later; τ must lie in [0, H) and P must not exceed H.
    At one offset, applies of earlier sends come before new sends."""
    P, H, tau = int(n_fragments), int(H), int(tau)
    if P < 1 or H < 1:
        raise ValueError(f"need P >= 1 and H >= 1, got P={P} H={H}")
    if P > H:
        raise ValueError(
            f"streaming needs P <= H to stagger every fragment on its "
            f"own inner offset, got P={P} H={H}")
    if not 0 <= tau < H:
        raise ValueError(f"stream_tau must be in [0, H): tau={tau} H={H}")
    send = tuple((p * H) // P or H for p in range(P))
    apply_abs = tuple(s + tau for s in send)

    events: dict[int, tuple[list, list]] = {}

    def at(off):
        return events.setdefault(off, ([], []))

    for p in range(P):
        at(send[p])[1].append(p)
        if tau > 0:
            a = apply_abs[p]
            at(a - H if a > H else a)[0].append(p)

    phases = []
    prev = 0
    for off in sorted(events):
        applies, sends = events[off]
        acts = [StreamEvent("apply", p, apply_abs[p] > H)
                for p in sorted(applies)]
        for p in sorted(sends):
            acts.append(StreamEvent("send", p, False))
            if tau == 0:
                acts.append(StreamEvent("apply", p, False))
        phases.append((off - prev, tuple(acts)))
        prev = off
    return StreamSchedule(P, H, tau, send, apply_abs, tuple(phases))
