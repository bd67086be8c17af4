"""Logical-axis sharding specification, as the JAX ``sharding/spec.py``.

Every parameter leaf has a tuple of *logical* axis names (one per dim,
None for unsharded; ``models.model.param_axes``). A rules table maps
logical names onto mesh axes; the mapping is divisibility-aware (an axis
whose size does not divide the mesh axis size falls back to replication,
e.g. starcoder2's 4 KV heads on a 16-way model axis) and greedy by
priority (for a given mesh axis, the highest-priority divisible logical
axis present on the leaf gets it; e.g. whisper's 20 heads don't divide 16
so the d_model/"embed" axis is sharded instead).

The mesh is a ``MeshShape`` of axis names and sizes, and a spec is a
tuple of mesh-axis names (or tuples of them) and None, one per dim: the
port lays out no device mesh. Its DiLoCo islands are the ranks of a pod
process group (``launch/mesh.py``), and its models run no model
parallelism within an island, so the JAX ``Boxed``, ``unbox`` and
``constrain`` (GSPMD annotations) have no counterpart here. The dry run
(``launch/dryrun.py``) reads these specs to size each leaf's bytes per
device (``shard_shape``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

# Logical axis -> mesh axis. Order in PRIORITY decides who wins a mesh axis
# when several logical axes on one param map to it.
DEFAULT_RULES: dict[str, str] = {
    "replica": "pod",    # stacked DiLoCo replicas live one-per-pod
    "batch": "data",
    "experts": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "inner": "model",    # mamba/xlstm expanded inner dim
    "embed": "model",    # fallback: shard d_model rows when heads don't divide
}

PRIORITY = ["replica", "batch", "experts", "heads", "kv_heads", "ff",
            "vocab", "inner", "embed"]


class MeshShape(NamedTuple):
    """A device mesh's axis names and sizes, e.g. (("data", "model"),
    (16, 16)). The JAX functions read only these two things of a mesh."""
    axis_names: tuple
    shape: tuple

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def devices(self) -> int:
        return math.prod(self.shape)


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The JAX dry run's meshes, read as H100s: (data 16, model 16), or
    (pod 2, data 16, model 16) with ``multi_pod``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def logical_to_pspec(axes: tuple, shape: tuple, mesh: MeshShape,
                     rules: dict[str, str] | None = None) -> tuple:
    """Map logical axes to a spec on ``mesh``, divisibility-aware."""
    rules = rules or DEFAULT_RULES
    mesh_sizes = mesh.sizes
    assignment: dict[int, str] = {}     # dim index -> mesh axis
    used_mesh: set[str] = set()
    # Greedy by priority: each mesh axis goes to the best divisible dim.
    for logical in PRIORITY:
        target = rules.get(logical)
        if target is None or target not in mesh_sizes or target in used_mesh:
            continue
        for i, name in enumerate(axes):
            if name == logical and i not in assignment \
                    and shape[i] % mesh_sizes[target] == 0 and shape[i] > 0:
                assignment[i] = target
                used_mesh.add(target)
                break
    return tuple(assignment.get(i) for i in range(len(axes)))


def tree_pspecs(axes_tree, param_tree, mesh: MeshShape,
                rules: dict[str, str] | None = None,
                extra_leading: tuple = ()):
    """Spec tree for a param tree (nested dicts of tensors) given its
    logical-axes tree. ``extra_leading`` prepends logical axes (e.g.
    ("replica",) for stacked DiLoCo replicas) to every leaf's axes."""
    if isinstance(param_tree, dict):
        return {k: tree_pspecs(axes_tree[k], v, mesh, rules, extra_leading)
                for k, v in param_tree.items()}
    return logical_to_pspec(tuple(extra_leading) + tuple(axes_tree),
                            tuple(param_tree.shape), mesh, rules)


def batch_pspec(mesh: MeshShape, batch_size: int, ndim: int,
                include_pod: bool = False) -> tuple:
    """Spec for an activation/batch array: shard dim 0 over data (and pod
    when requested), divisibility-aware; rest replicated."""
    mesh_sizes = mesh.sizes
    axes = []
    if include_pod and "pod" in mesh_sizes:
        axes.append("pod")
    if "data" in mesh_sizes:
        axes.append("data")
    total = math.prod(mesh_sizes[a] for a in axes) if axes else 1
    while axes and batch_size % total != 0:
        total //= mesh_sizes[axes.pop()]
    # one axis stands bare, as a PartitionSpec normalises it
    first = (axes[0] if len(axes) == 1 else tuple(axes)) if axes else None
    return (first,) + (None,) * (ndim - 1)


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_shape(shape: tuple, spec: tuple, mesh: MeshShape) -> tuple:
    """One device's block of a ``shape`` leaf laid out by ``spec``: each
    dim divided (rounding up) by the sizes of the mesh axes it is sharded
    over."""
    sizes = mesh.sizes
    return tuple(-(-int(d) // math.prod(sizes[a] for a in entry_axes(e)))
                 for d, e in zip(shape, spec))


def shard_bytes(t, spec: tuple, mesh: MeshShape) -> int:
    """Bytes one device holds of tensor ``t`` laid out by ``spec``."""
    return math.prod(shard_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()
