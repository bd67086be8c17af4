"""The dry run's shapes and shardings against the JAX package: ``SHAPES``,
the registry's ``shape_cfg`` / ``input_specs`` / ``cache_specs`` /
``abstract_params`` (shapes, dtypes and the logical-axes tree of every
leaf of all 13 configs at full width), and ``logical_to_pspec``,
``batch_pspec``, ``param_pspec`` and ``cache_pspec`` on the meshes (16,
16), (2, 16, 16), (2, 2) and (2, 2, 2). The JAX functions read only a
mesh's ``axis_names`` and ``devices.shape``, so a duck-typed mesh serves;
nothing here lowers or compiles."""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.models import registry as JR
from repro.sharding import spec as JSP
from repro_torch import tree
from repro_torch.configs import base as TB
from repro_torch.launch import dryrun as TD
from repro_torch.models import registry as TR
from repro_torch.sharding import spec as TSP

import dryrun_common

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}


@pytest.fixture(scope="module")
def jax_dryrun():
    return dryrun_common.import_jax_dryrun()


def _meshes():
    for shape, names in MESHES.items():
        jmesh = SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=np.int8))
        yield jmesh, TSP.MeshShape(names, shape)


def _jax_leaves(t):
    """[(dotted path, leaf)] of a JAX tree, tuples of axes as leaves."""
    flat = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _dt(d) -> str:
    return str(d).replace("torch.", "")


@pytest.fixture(scope="module")
def abstract():
    """Per arch: (JAX shapes, JAX axes, port meta params, port axes)."""
    out = {}
    for name in JR.ARCH_NAMES:
        js, jax_axes = JR.get_arch(name).abstract_params()
        tp, tax = TR.get_arch(name).abstract_params()
        out[name] = (_jax_leaves(js), _jax_leaves(jax_axes),
                     dict(tree.paths(tp)), dict(tree.paths(tax)))
    return out


def test_shapes_and_window():
    assert {n: dataclasses.astuple(s) for n, s in TB.SHAPES.items()} == \
        {n: dataclasses.astuple(s) for n, s in JB.SHAPES.items()}
    assert TB.LONG_CONTEXT_WINDOW == JB.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("name", JR.ARCH_NAMES)
def test_shape_cfg_inputs_and_caches(name):
    ja, ta = JR.get_arch(name), TR.get_arch(name)
    for sname, jshape in JB.SHAPES.items():
        tshape = TB.SHAPES[sname]
        jc, tc = ja.shape_cfg(jshape), ta.shape_cfg(tshape)
        assert dataclasses.asdict(tc) == {
            f.name: getattr(jc, f.name) for f in dataclasses.fields(tc)}
        for b in (0, 3):
            ji = ja.input_specs(jshape, batch_override=b, dtype=jnp.bfloat16)
            ti = ta.input_specs(tshape, batch_override=b,
                                dtype=torch.bfloat16)
            assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ji.items()} \
                == {k: (tuple(v.shape), _dt(v.dtype)) for k, v in ti.items()}
            assert all(v.device.type == "meta" for v in ti.values())
        jcache = ja.cache_specs(jshape, batch_override=2, dtype=jnp.bfloat16)
        tcache = ta.cache_specs(tshape, batch_override=2,
                                dtype=torch.bfloat16)
        want = sorted(
            (".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(jcache)[0])
        got = sorted((".".join(str(e[1]) for e in path), tuple(v.shape),
                      _dt(v.dtype))
                     for path, v in tree.flatten_with_path(tcache))
        assert got == want, sname


def test_abstract_params_shapes_and_axes(abstract):
    for name, (jshapes, jaxes, tshapes, taxes) in abstract.items():
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in
                jshapes.items()} == \
            {k: (tuple(v.shape), _dt(v.dtype)) for k, v in tshapes.items()}, \
            name
        assert all(v.device.type == "meta" for v in tshapes.values())
        assert taxes == jaxes, name


def test_logical_and_param_pspecs(abstract, jax_dryrun):
    n = 0
    for jmesh, tmesh in _meshes():
        for name, (jshapes, jaxes, _, _) in abstract.items():
            for path, ax in jaxes.items():
                shape = tuple(jshapes[path].shape)
                for lead in ((), ("replica",)):
                    axes, shp = lead + ax, (2,) * len(lead) + shape
                    assert TSP.logical_to_pspec(axes, shp, tmesh) == \
                        tuple(JSP.logical_to_pspec(axes, shp, jmesh))
                    for fsdp in (True, False):
                        assert TD.param_pspec(axes, shp, tmesh, fsdp) == \
                            tuple(jax_dryrun.param_pspec(axes, shp, jmesh,
                                                         fsdp)), (name, path)
                    n += 1
    assert n == 2880


def test_batch_pspecs():
    for jmesh, tmesh in _meshes():
        for B in (1, 2, 3, 4, 8, 32, 128, 256, 512):
            for ndim in (1, 2, 3):
                for pod in (False, True):
                    assert TSP.batch_pspec(tmesh, B, ndim, pod) == \
                        tuple(JSP.batch_pspec(jmesh, B, ndim, pod))


def test_cache_pspecs(jax_dryrun):
    n = 0
    for name in JR.ARCH_NAMES:
        ja = JR.get_arch(name)
        for sname in ("decode_32k", "long_500k"):
            cache = ja.cache_specs(JB.SHAPES[sname], dtype=jnp.bfloat16)
            for leaf in jax.tree.leaves(cache):
                if not jnp.issubdtype(leaf.dtype, jnp.floating):
                    continue
                for jmesh, tmesh in _meshes():
                    for pod in (False, True):
                        assert TD.cache_pspec(tuple(leaf.shape), tmesh,
                                              include_pod=pod) == \
                            tuple(jax_dryrun.cache_pspec(
                                leaf.shape, jmesh, include_pod=pod))
                        n += 1
    assert n > 500


def test_shard_shape_and_bytes():
    mesh = TSP.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert TSP.shard_shape((4, 4096, 50304), (None, "data", "model"),
                           mesh) == (4, 256, 3144)
    assert TSP.shard_shape((256, 8), (("pod", "data"), None), mesh) == \
        (8, 8)
    t = torch.empty((32, 100), dtype=torch.bfloat16, device="meta")
    assert TSP.shard_bytes(t, ("data", None), mesh) == 2 * 100 * 2


def test_tree_pspecs_stack_replicas():
    """The tree form: every leaf's spec with the stacked replicas' axis
    first, as JAX's ``tree_shardings(..., extra_leading=("replica",))``
    lays them out (its specs, leaf by leaf)."""
    arch = TR.get_arch("olmoe_1b_7b")
    params, axes = arch.abstract_params()
    stacked = tree.map(lambda t: torch.empty((2,) + tuple(t.shape),
                                             device="meta"), params)
    for jmesh, tmesh in _meshes():
        got = TSP.tree_pspecs(axes, stacked, tmesh,
                              extra_leading=("replica",))
        for (path, spec), (_, ax), (_, t) in zip(
                tree.paths(got), tree.paths(axes), tree.paths(stacked)):
            assert spec == tuple(JSP.logical_to_pspec(
                ("replica",) + ax, tuple(t.shape), jmesh)), path
