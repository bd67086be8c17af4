"""FSDP×TP within an island on real ranks against JAX's unsharded step.

The port's counterpart of JAX's sharded lowering is the dry run's train
step on an island's DTensors (``launch/island.py`` runs it on gloo CPU
ranks, one process a chip): params, moments and batch laid out by
``param_pspec`` on a (data, model) mesh, the residual stream constrained
as JAX's ``constrain`` sites say, DTensor's propagation inserting the
collectives. Here one group of four ranks runs it as (data 2, model 2)
and one of two as (data 1, model 2), each on the same seeded numpy params
(the family tests' perturbed smoke params: every all-zero and all-one
leaf perturbed), AdamW state and batch as JAX's unsharded
``build_train_step`` (the JAX dry run's step: bf16 cast, f32
accumulation over microbatches, clip, AdamW). The state starts from m = 0
and the second moments of ``island.second_moments``' law, so that the
update is smooth in the gradient (from v = 0 it is lr·sign(g), flipped
by any other summation order at entries within eps of 0).

Held: the loss and every param after one AdamW step at atol 1e-5 and
rtol 1e-4, the port's f32 bound (TP reorders the sums); and AdamW's first
moments (0.1 of the clipped gradient, which both packages round to bf16
once per microbatch after its reduce) leaf by leaf within one bf16 ulp of
the leaf's largest entry per microbatch (2⁻⁷·mb of max|m|), which a wrong
gradient in any leaf exceeds. The cases: two dense configs (diloco_60m,
qwen3_32b), a cross-attention one (llama_3_2_vision_90b), the
``seq_parallel`` and ``no_act_shard`` layouts of the residual stream,
``cast_outside_mb`` (the FSDP gather hoisted out of the microbatch loop),
and the flash branch on each rank's own heads (JAX's Pallas flash kernels
in interpret mode, as ``tests/test_torch_flash_bf16.py`` runs them).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro_torch.launch import mesh

import dryrun_common
import families_common as FC

B, S = 4, 16
ATOL, RTOL = 1e-5, 1e-4
# AdamW's first moments: one bf16 ulp of the leaf's largest entry per
# microbatch (2⁻⁷ of it: bf16 keeps 8 significant bits)
M_REL = 2.0 ** -7

# id -> (smoke config, cfg changes of both packages, cfg changes of the
# port's step (the layout of its activations), step options)
CASES = {
    "diloco_60m": ("diloco_60m", {}, {}, {}),
    "qwen3_32b": ("qwen3_32b", {}, {}, {}),
    "llama_vision": ("llama_3_2_vision_90b", {}, {}, {}),
    "seq_parallel": ("diloco_60m", {}, {"act_seq_shard": True,
                                        "act_model_shard": False}, {}),
    "no_act_shard": ("diloco_60m", {}, {"act_model_shard": False}, {}),
    "cast_outside_mb": ("diloco_60m", {}, {}, {"cast_outside_mb": True}),
    # the flash branch (head_dim 128, seq 128), JAX's in interpret mode
    "flash": ("diloco_400m", {"head_dim": 128, "use_pallas": True}, {}, {}),
}
# (data, model) -> (microbatches, the cases its group runs). Each group
# runs two microbatches, so the gradients of each pass through JAX's bf16
# cast and are rounded once per microbatch before they are summed. On two
# data ranks a sharded step splits each rank's own rows into microbatches
# (``dryrun._microbatch``), which groups the rows otherwise than JAX's
# contiguous split; the bounds hold all the same because the step starts
# from seeded v, so that AdamW's update is smooth in the gradient and the
# other grouping moves each param by far less than the f32 bound (from
# v = 0 the first update is lr·sign(g), which any other rounding flips at
# the entries that are sums of near-cancelling terms). ``cast_outside_mb``
# runs on both meshes: on (1, 2) the data axis has one rank and FSDP's
# hoisted gathers are trivial, on (2, 2) they are not.
GROUPS = {(2, 2): (2, ["diloco_60m", "qwen3_32b", "llama_vision",
                       "seq_parallel", "no_act_shard", "cast_outside_mb"]),
          (1, 2): (2, ["diloco_60m", "cast_outside_mb", "flash"])}


def _case(name):
    """(JAX arch, the port's cfg, step options, numpy params, numpy v,
    batch); both packages without remat (it recomputes, and changes no
    value)."""
    arch_name, model, layout, opts = CASES[name]
    ja, ta, jp, _ = FC.archs(arch_name, **model)
    s = 128 if model.get("use_pallas") else S
    batch = FC.batch_np(ja.cfg, seed=3, b=B, s=s)
    ja = type(ja)(cfg=ja.cfg.replace(remat=False))
    jp = jax.tree.map(np.asarray, jp)
    return ja, ta.cfg.replace(remat=False, **layout), opts, jp, \
        _second_moments(jp), batch


def _second_moments(params, seed=5):
    """``island.second_moments``' law in numpy: (u / √N)², u uniform in
    [0.5, 1.5), N the params' entries."""
    rng = np.random.default_rng(seed)
    n = sum(x.size for x in jax.tree.leaves(params))
    return jax.tree.map(lambda x: ((0.5 + rng.random(x.shape)) ** 2 / n)
                        .astype(np.float32), params)


def _jax_steps():
    """JAX's unsharded step on each group's cases: (loss, params after
    it, first moments after it), by (data, model) and case; the flash
    case with JAX's flash kernels in interpret mode."""
    jd = dryrun_common.import_jax_dryrun()
    jax_fa = jops.flash_attention

    def interpret(*args, **kw):
        return jax_fa(*args, **{**kw, "mode": "interpret"})
    out = {}
    for shape, (mb, names) in GROUPS.items():
        for name in names:
            ja, _, opts, jp, v, batch = _case(name)
            with pytest.MonkeyPatch.context() as mp:
                if ja.cfg.use_pallas:
                    mp.setattr(jops, "flash_attention", interpret)
                step = jax.jit(jd.build_train_step(
                    ja, ja.cfg, groups=1, microbatches=mb, **opts))
                p, m, _, _, loss = step(
                    jp, jax.tree.map(jnp.zeros_like, jp), v,
                    jnp.zeros((), jnp.int32), FC.to_jax(batch))
                out[shape, name] = (float(loss), jax.tree.map(np.asarray, p),
                                    jax.tree.map(np.asarray, m))
    return out


def _ranks(shape):
    """The ranks' results of one group, by case."""
    mb, names = GROUPS[shape]
    cases = []
    for name in names:
        _, cfg, opts, jp, v, batch = _case(name)
        cases.append({"cfg": cfg, "params": jp, "v": v, "batch": batch,
                      "microbatches": mb, **opts})
    res = mesh.spawn("repro_torch.launch.island:train_steps",
                     mesh.make_pod_layout(shape[0] * shape[1], "cpu"),
                     shape, cases)
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def results():
    """(JAX's steps, each group's ranks' results by (data, model)): the
    groups run at once (process groups of their own) while JAX compiles
    its steps."""
    for name in CASES:          # the JAX params, made once, before threads
        _case(name)
    with ThreadPoolExecutor(len(GROUPS)) as pool:
        running = {shape: pool.submit(_ranks, shape) for shape in GROUPS}
        want = _jax_steps()
        return want, {shape: f.result() for shape, f in running.items()}


@pytest.mark.parametrize("shape,name", [(s, n) for s, (_, ns) in
                                        GROUPS.items() for n in ns],
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_sharded_step_matches_jax_unsharded(results, shape, name):
    want, got = results
    got = got[shape][name]
    want_loss, want_params, want_m = want[shape, name]
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=RTOL,
                               atol=ATOL)
    FC.assert_tree_close(got[0]["params"], want_params, RTOL, ATOL,
                         "params ")
    bound = M_REL * GROUPS[shape][0]
    m = FC.flat(want_m)
    for path, x in FC.flat(got[0]["m"]).items():
        top = np.abs(m[path]).max()
        assert np.abs(x - m[path]).max() <= bound * top, (path, top)
    # the model axis carries the TP collectives on every mesh, the data
    # axis FSDP's gathers and reduce-scatters where it has two ranks
    ops = {op for op, _ in got[0]["collectives"]}
    assert ops >= {"all-gather", "all-reduce"}, ops
    if shape[0] > 1:
        assert "reduce-scatter" in ops, ops
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"] and "params" not in r
        assert sorted(r["collectives"]) == sorted(got[0]["collectives"])
