"""FSDP×TP within an island for the xLSTM family (mLSTM and sLSTM cells)
on real ranks against JAX's unsharded step (``tests/test_torch_island.py``
holds the dense and cross-attention families, ``test_torch_island_moe.py``
MoE/MLA, ``test_torch_island_hybrid.py`` Mamba2).

Each rank runs its own block of the inner width D on plain tensors, with
no collective inside the per-token loop (``models/xlstm.py``): the mLSTM
its value columns (C as (B_l, H_l, dk, dv_l); q, k, i and f of the heads
its block touches), the sLSTM the whole heads its block touches (its own
pre-activation columns gathered over "model" where the block is part of
a head); the RMSNorm's squares summed over "model", ``wo``'s and
``w_down``'s own rows. The xlstm smoke config (one mLSTM and one sLSTM
block, ``slstm_every=2``, d_model 128), every all-zero and all-one leaf
perturbed, runs one AdamW step of the dry run's train step at 2
microbatches on (data 2, model 2) and (data 1, model 2) gloo ranks, held
to JAX's unsharded ``build_train_step`` on the same params, state and
batch; and with one head (``n_heads=1``) on (1, 2), where the heads do
not divide "model": each rank holds half of the head's value columns, as
xlstm_350m's 4 heads on 16 model ranks do. The bounds are the dense
family's: the loss and every param at atol 1e-5, rtol 1e-4; the first
moments leaf by leaf within 2⁻⁷ of the leaf's largest per microbatch.
Both configs are also served (4 heads on (2, 2), one head on (1, 2)): a
prefill and three decode steps (``island.serve_steps``: the state laid
out by ``cache_pspec``, C with dk over "model", brought to the cell's
layout and back at each call) against JAX's unsharded prefill and
decode, the logits at atol 1e-5, rtol 1e-4.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.launch import mesh
from repro_torch.models.xlstm import shift_free

import dryrun_common
import families_common as FC
from test_torch_island import ATOL, B, M_REL, RTOL, S, _second_moments

MB = 2
ARCH = "xlstm_350m"
# id -> (the config's changes, the mesh it trains on; it is served on the
# same mesh)
CASES = {"heads4-2x2": ({}, (2, 2)), "heads4-1x2": ({}, (1, 2)),
         "heads1-1x2": ({"n_heads": 1}, (1, 2))}
SERVED = ("heads4-2x2", "heads1-1x2")


def _case(model):
    """(JAX arch, the port's cfg, numpy params, numpy v, batch), both
    packages without remat."""
    ja, ta, jp, _ = FC.archs(ARCH, **model)
    assert ja.cfg.slstm_every == 2 and ja.cfg.n_layers == 2
    batch = FC.batch_np(ja.cfg, seed=3, b=B, s=S)
    ja = type(ja)(cfg=ja.cfg.replace(remat=False))
    jp = jax.tree.map(np.asarray, jp)
    return ja, ta.cfg.replace(remat=False), jp, _second_moments(jp), batch


@functools.lru_cache(maxsize=None)
def _jax_step(heads):
    """JAX's unsharded step of the config with ``heads`` heads (None: the
    smoke config's): (loss, params, first moments)."""
    jd = dryrun_common.import_jax_dryrun()
    ja, _, jp, v, batch = _case({} if heads is None else {"n_heads": heads})
    step = jax.jit(jd.build_train_step(ja, ja.cfg, groups=1,
                                       microbatches=MB))
    p, m, _, _, loss = step(jp, jax.tree.map(jnp.zeros_like, jp), v,
                            jnp.zeros((), jnp.int32), FC.to_jax(batch))
    return float(loss), jax.tree.map(np.asarray, p), \
        jax.tree.map(np.asarray, m)


def _ranks(shape, ids):
    """The cases ``ids``' steps on one spawn of ``shape``'s ranks: {id:
    every rank's result}."""
    cases = []
    for i in ids:
        _, cfg, jp, v, batch = _case(CASES[i][0])
        cases.append({"cfg": cfg, "params": jp, "v": v, "batch": batch,
                      "microbatches": MB})
    res = mesh.spawn("repro_torch.launch.island:train_steps",
                     mesh.make_pod_layout(shape[0] * shape[1], "cpu"),
                     shape, cases)
    return {i: [r[j] for r in res] for j, i in enumerate(ids)}


def _serve(i):
    """Case ``i``'s prefill and decode logits on its ranks."""
    model, shape = CASES[i]
    _, cfg, jp, _, _ = _case(model)
    rng = np.random.default_rng(4)
    case = {"cfg": cfg, "params": jp,
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "next": rng.integers(0, cfg.vocab_size, (B, 3))}
    res = mesh.spawn("repro_torch.launch.island:serve_steps",
                     mesh.make_pod_layout(shape[0] * shape[1], "cpu"), shape,
                     [case])
    return case, res[0][0]


@pytest.fixture(scope="module")
def results():
    for model, _ in CASES.values():  # the JAX params, made before threads
        _case(model)
    shapes = {}
    for i, (_, shape) in CASES.items():
        shapes.setdefault(shape, []).append(i)
    with ThreadPoolExecutor(len(shapes) + len(SERVED)) as pool:
        running = [pool.submit(_ranks, shape, ids)
                   for shape, ids in shapes.items()]
        serving = {i: pool.submit(_serve, i) for i in SERVED}
        want = {i: _jax_step(CASES[i][0].get("n_heads")) for i in CASES}
        got = {}
        for f in running:
            got.update(f.result())
        return want, got, {i: f.result() for i, f in serving.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_xlstm_sharded_step_matches_jax_unsharded(results, case):
    want, got, _ = results
    got = got[case]
    want_loss, want_params, want_m = want[case]
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=RTOL,
                               atol=ATOL)
    FC.assert_tree_close(got[0]["params"], want_params, RTOL, ATOL,
                         "params ")
    # the input-gate biases' exact gradient is 0 (``xlstm.shift_free``):
    # both packages' moments there are round-off, held to the tree's scale
    m = FC.flat(want_m)
    tree_top = max(np.abs(x).max() for x in m.values())
    for path, x in FC.flat(got[0]["m"]).items():
        top = tree_top if shift_free(".".join(path)) \
            else np.abs(m[path]).max()
        assert np.abs(x - m[path]).max() <= M_REL * MB * top, (path, top)
    # the weights' gathers and their gradients' reduce-scatters, the
    # norms' sums of squares; every rank issues the same collectives, and
    # as many at 16 tokens as the loop's length would give at any other
    # (``tests/test_torch_dryrun_xlstm.py`` holds the count to T)
    ops = {op for op, _ in got[0]["collectives"]}
    assert ops >= {"all-gather", "all-reduce", "reduce-scatter"}, ops
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"] and "params" not in r
        assert sorted(r["collectives"]) == sorted(got[0]["collectives"])


@pytest.mark.parametrize("case", SERVED)
def test_xlstm_serving_on_island_matches_jax_unsharded(results, case):
    """A prefill of the prompt and three decode steps on the case's ranks
    against JAX's unsharded prefill and decode: each step's last logits
    at the family tests' atol 1e-5, rtol 1e-4 (the cells read their state
    where ``cache_pspec`` lays it, from a cache whose stabiliser m starts
    at −1e30, and write it back there)."""
    served, got = results[2][case]
    ja, _, jp, _, _ = _case(CASES[case][0])
    jp = jax.tree.map(jnp.asarray, jp)
    S_, n = served["tokens"].shape[1], served["next"].shape[1]
    lg, cache = ja.prefill(jp, {"tokens": jnp.asarray(served["tokens"],
                                                      jnp.int32)},
                           cache_len=S_ + n)
    want = [lg[:, -1]]
    for i in range(n):
        lg, cache = ja.decode(jp, cache, jnp.asarray(
            served["next"][:, i:i + 1], jnp.int32), jnp.asarray(S_ + i,
                                                                jnp.int32))
        want.append(lg[:, -1])
    logits = got["logits"]
    assert len(logits) == len(want)
    for step, (a, b) in enumerate(zip(logits, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")
