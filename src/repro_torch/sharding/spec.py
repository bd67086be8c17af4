"""Logical-axis sharding specification, as the JAX ``sharding/spec.py``.

Every parameter leaf has a tuple of *logical* axis names (one per dim,
None for unsharded; ``models.model.param_axes``). A rules table maps
logical names onto mesh axes; the mapping is divisibility-aware (an axis
whose size does not divide the mesh axis size falls back to replication,
e.g. starcoder2's 4 KV heads on a 16-way model axis) and greedy by
priority (for a given mesh axis, the highest-priority divisible logical
axis present on the leaf gets it; e.g. whisper's 20 heads don't divide 16
so the d_model/"embed" axis is sharded instead).

A ``MeshShape`` names a mesh's axes and sizes, and a spec is a tuple of
mesh-axis names (or tuples of them) and None, one per dim. The dry run
(``launch/dryrun.py``) reads the specs to size each leaf's bytes per
device (``shard_shape``).

Within an island the specs are applied, as GSPMD applies JAX's, by
``torch.distributed.tensor`` (DTensor) on a ``DeviceMesh`` with axes
("data", "model") (``island_mesh``): ``param_pspec`` lays out each
parameter FSDP×TP (``shard_params``; each sharded dim a ``Shard(dim)``
on its mesh axis, everything else ``Replicate()``), and ``constrain``,
the counterpart of JAX's ``with_sharding_constraint`` sites, redistributes
an activation to a spec. DTensor's sharding propagation inserts the
collectives between them, as GSPMD does. On plain tensors (every run
without an island mesh) ``constrain`` is the identity, so the model's
code is the same on one card and on a mesh. The JAX ``Boxed`` and
``unbox`` have no counterpart: the port keeps the axes beside the init
(``models.model.param_axes``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

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


# ---------------------------------------------------------------------------
# the dry run's layouts (the JAX ``launch/dryrun.py``'s)
# ---------------------------------------------------------------------------

def param_pspec(axes: tuple, shape: tuple, mesh: MeshShape,
                fsdp: bool = True) -> tuple:
    """2-D param sharding: model-parallel pass (priority rules), then an
    FSDP pass putting 'embed' rows on "data" if still free.

    Exception, as in the JAX dry run: *gathered* tables (axes start with
    "vocab") whose vocab dim does not divide the model axis are fully
    replicated (a gather from a feature-sharded table mis-lowers under
    XLA's SPMD partitioner, and a data-sharded table is all-gathered every
    step anyway)."""
    sizes = mesh.sizes
    if (axes and axes[0] == "vocab" and "model" in sizes
            and shape[0] % sizes["model"] != 0):
        return (None,) * len(axes)
    spec = list(logical_to_pspec(axes, shape, mesh))
    if fsdp and "data" in sizes and "data" not in spec:
        for i, name in enumerate(axes):
            if (spec[i] is None and name == "embed"
                    and shape[i] % sizes["data"] == 0):
                spec[i] = "data"
                break
    return tuple(spec)


def cache_pspec(shape: tuple, mesh: MeshShape, *, include_pod: bool) -> tuple:
    """Decode-cache sharding: leading (groups) dim replicated, batch dim
    over ("pod"?, "data") when divisible, and ONE more dim over "model"
    (kv-heads first, then the sequence dim, then feature dims); a batch too
    small for "data" puts the sequence dim on it instead."""
    sizes = mesh.sizes
    nd = len(shape)
    spec = [None] * nd
    if nd >= 2:
        axes = []
        if include_pod and "pod" in sizes:
            axes.append("pod")
        axes.append("data")
        total = math.prod(sizes[a] for a in axes)
        while axes and shape[1] % total != 0:
            total //= sizes[axes.pop()]
        if axes:
            spec[1] = tuple(axes) if len(axes) > 1 else axes[0]
    if "model" in sizes and nd >= 3:
        for i in [3, 2, nd - 1, nd - 2]:
            if 2 <= i < nd and spec[i] is None \
                    and shape[i] % sizes["model"] == 0 and shape[i] > 1:
                spec[i] = "model"
                break
    if spec[1] is None and "data" in sizes and nd >= 4:
        for i in [2, nd - 2]:
            if 2 <= i < nd and spec[i] is None \
                    and shape[i] % sizes["data"] == 0 and shape[i] > 1:
                spec[i] = "data"
                break
    return tuple(spec)


# ---------------------------------------------------------------------------
# DTensor: the specs applied on an island's device mesh
# ---------------------------------------------------------------------------

def island_mesh(shape: tuple, axes: tuple = ("data", "model"),
                device_type: str = "cuda"):
    """A ``DeviceMesh`` of this process group's first prod(shape) ranks,
    laid out row-major as ``shape`` with axis names ``axes`` (the JAX
    island mesh). The default process group must be up."""
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a ``DeviceMesh``."""
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of a spec on ``mesh``: for each mesh axis, a
    ``Shard(dim)`` where the spec puts a dim on it, else ``Replicate()``
    (a dim on several axes takes each of them, in order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        for ax in entry_axes(entry):
            i = names.index(ax)
            if out[i].is_shard():
                raise ValueError(f"spec {spec}: mesh axis {ax!r} shards two "
                                 "dims")
            out[i] = Shard(dim)
    return out


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local_blocks(*ts) -> tuple:
    """This rank's blocks of DTensors of one layout (elementwise work runs
    on them as they lie), marked as one of the blocks the work is split
    into (``mark_local``), or the tensors themselves when none is a
    DTensor; DTensors of different layouts are refused."""
    if not any(is_dtensor(t) for t in ts):
        return ts
    first = next(t for t in ts if is_dtensor(t))
    for t in ts:
        if not is_dtensor(t) or t.device_mesh != first.device_mesh \
                or tuple(t.placements) != tuple(first.placements) \
                or t.shape != first.shape:
            raise ValueError(
                "elementwise work takes DTensors of one layout: got "
                f"{[getattr(x, 'placements', None) for x in ts]}")
    return mark_local(first, *(t.to_local() for t in ts))


def distribute(t, spec: tuple, mesh):
    """``t`` laid out by ``spec`` on ``mesh``, from its full value, which
    every rank holds: each rank keeps its own block (cut here, so nothing
    is communicated); a meta tensor becomes a DTensor of meta blocks
    (nothing allocated)."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, mesh)
    if t.device.type == "meta":
        block = torch.empty(shard_shape(tuple(t.shape), spec,
                                        mesh_shape(mesh)),
                            dtype=t.dtype, device="meta")
    else:
        block = block_of(t, pl, mesh).contiguous()
    return DTensor.from_local(block, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def block_of(t, pl, mesh):
    """This rank's block (a view) of the full tensor ``t`` laid out by the
    placements ``pl`` on ``mesh``: each mesh axis in order (outer first)
    cuts the dim it shards, as DTensor cuts it."""
    for i, p in enumerate(pl):
        if p.is_shard():
            t = torch.chunk(t, mesh.size(i), p.dim)[mesh.get_local_rank(i)]
    return t


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (computed: a tensor
    made for them would count as storage where storage is counted)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= int(d)
    return tuple(reversed(out))


def from_block(block, mesh, pl, shape):
    """A DTensor of global ``shape`` (contiguous) from this rank's
    ``block``, laid out by the placements ``pl`` on ``mesh``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    return DTensor.from_local(block, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def empty_on_mesh(shape, dtype, spec: tuple, mesh, *, fill, device):
    """A DTensor of ``shape`` laid out by ``spec`` on ``mesh``, each rank
    making only its own block, filled with ``fill``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    block = torch.full(shard_shape(shape, spec, mesh_shape(mesh)), fill,
                       dtype=dtype, device=device)
    return DTensor.from_local(block, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def shard_params(params, axes, mesh, *, fsdp: bool = True,
                 pure_dp: bool = False):
    """The param tree as DTensors in ``param_pspec``'s layout (``fsdp``
    False: model-sharded only; ``pure_dp``: every leaf replicated), the
    leaves' logical axes from ``axes`` (``models.model.param_axes``)."""
    from .. import tree
    ms = mesh_shape(mesh)
    specs = [(None,) * t.dim() if pure_dp
             else param_pspec(tuple(ax), tuple(t.shape), ms, fsdp)
             for t, ax in zip(tree.leaves(params), tree.leaves(axes))]
    return tree.unflatten(params, [distribute(t, sp, mesh) for t, sp in
                                   zip(tree.leaves(params), specs)])


# the attribute that marks a rank's local block of an island's work with
# the number of distinct blocks it is one of (``launch/op_cost.py``
# multiplies the counts of the plain ops that read it)
BLOCKS = "_island_blocks"


def mark_local(like, *blocks):
    """Mark plain tensors as this rank's share of work split over the mesh
    axes that DTensor ``like`` (or any of a tuple of them) is sharded on:
    the other ranks of those axes do the other blocks, the ranks of an
    axis they are all replicated on repeat the same work. Returns
    ``blocks``."""
    likes = like if isinstance(like, tuple) else (like,)
    mesh = likes[0].device_mesh
    return mark_blocks(math.prod(
        mesh.size(i) for i in range(mesh.ndim)
        if any(t.placements[i].is_shard() for t in likes)), *blocks)


def mark_blocks(n: int, *blocks):
    """Mark plain tensors as one of ``n`` distinct blocks of an island's
    work (``mark_local`` with the count given). Returns ``blocks``."""
    for t in blocks:
        setattr(t, BLOCKS, n)
    return blocks


def on_mesh(*trees):
    """A context in which a function of the trees' DTensors runs: plain
    tensors the model makes itself (positions, masks, RoPE tables, 0-d
    scalars) count as replicated on the mesh (DTensor's
    ``implicit_replication``). Where no leaf is a DTensor, nothing."""
    import contextlib

    from .. import tree
    if not any(is_dtensor(t) for x in trees for t in tree.leaves(x)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def constrain(x, spec: tuple):
    """``x`` redistributed to ``spec`` on its own mesh, the counterpart of
    the JAX ``constrain`` (``with_sharding_constraint``): a plain tensor
    (no mesh) comes back as it is. Mesh axes the spec names that the mesh
    lacks, or that have one rank (they split nothing, and DTensor cannot
    fold a dim split over one into its neighbours), are dropped, as is a
    dim whose size the axis does not divide (GSPMD pads it; a DTensor
    would split it unevenly)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    keep = []
    for d, entry in enumerate(spec):
        axes = tuple(a for a in entry_axes(entry)
                     if a in sizes and sizes[a] > 1)
        n = math.prod(sizes[a] for a in axes)
        keep.append(axes if axes and x.shape[d] % n == 0 else None)
    pl = placements(tuple(keep), mesh)
    if list(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)
