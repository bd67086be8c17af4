"""FSDP×TP within an island for the MoE/MLA family on real ranks against
JAX's unsharded step (``tests/test_torch_island.py`` holds the dense and
cross-attention families the same way).

The MoE dispatch runs as JAX's three constrain sites lay it out: the
grouped tokens over "data", the (G, E, C, D) buffer's experts over
"model", the experts' output back over "data"; the router's softmax,
top-k, dispatch and combine on each rank's own groups. MLA keeps its
heads over "model" and its latent whole there. The olmoe and deepseek
smoke configs (every all-zero and all-one leaf perturbed) run one AdamW
step of the dry run's train step at 2 microbatches on (data 2, model 2)
and (data 1, model 2) gloo ranks, the tokens grouped by the data axis's
size, and JAX's unsharded ``build_train_step`` runs the same params,
state and batch at the same ``groups`` (capacity is per group). The
bounds are the dense family's: the loss and every param at atol 1e-5,
rtol 1e-4; the first moments leaf by leaf within 2⁻⁷ of the leaf's
largest per microbatch. ``cast_outside_mb`` (FSDP's gathers hoisted out
of the microbatch loop) runs on (2, 2) for olmoe. Both configs are also
served on (2, 2): a prefill and three decode steps (``island.
serve_steps``; the MoE's decode grouping, MLA's latent ring with its
features over "model") against JAX's unsharded prefill and decode, the
logits at atol 1e-5, rtol 1e-4.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.launch import mesh

import dryrun_common
import families_common as FC
from test_torch_island import ATOL, B, M_REL, RTOL, S, _second_moments

MB = 2
# id -> (smoke config, step options)
CASES = {"olmoe": ("olmoe_1b_7b", {}),
         "deepseek": ("deepseek_v2_lite_16b", {}),
         "olmoe_cast_outside_mb": ("olmoe_1b_7b", {"cast_outside_mb": True})}
# (data, model) -> the cases its group runs
GROUPS = {(2, 2): ["olmoe", "deepseek", "olmoe_cast_outside_mb"],
          (1, 2): ["olmoe", "deepseek"]}
# the configs served (a prefill, then decode steps) on (2, 2)
SERVE = ["olmoe", "deepseek"]


def _case(name):
    """(JAX arch, the port's cfg, step options, numpy params, numpy v,
    batch), both packages without remat."""
    arch_name, opts = CASES[name]
    ja, ta, jp, _ = FC.archs(arch_name)
    batch = FC.batch_np(ja.cfg, seed=3, b=B, s=S)
    ja = type(ja)(cfg=ja.cfg.replace(remat=False))
    jp = jax.tree.map(np.asarray, jp)
    return ja, ta.cfg.replace(remat=False), opts, jp, _second_moments(jp), \
        batch


def _jax_steps():
    """JAX's unsharded step of each group's cases, its tokens grouped by
    the group's data axis: (loss, params, first moments) by (data, model)
    and case."""
    jd = dryrun_common.import_jax_dryrun()
    out = {}
    for shape, names in GROUPS.items():
        for name in names:
            ja, _, opts, jp, v, batch = _case(name)
            step = jax.jit(jd.build_train_step(
                ja, ja.cfg, groups=shape[0], microbatches=MB, **opts))
            p, m, _, _, loss = step(
                jp, jax.tree.map(jnp.zeros_like, jp), v,
                jnp.zeros((), jnp.int32), FC.to_jax(batch))
            out[shape, name] = (float(loss), jax.tree.map(np.asarray, p),
                                jax.tree.map(np.asarray, m))
    return out


def _ranks(shape):
    cases = []
    for name in GROUPS[shape]:
        _, cfg, opts, jp, v, batch = _case(name)
        cases.append({"cfg": cfg, "params": jp, "v": v, "batch": batch,
                      "microbatches": MB, **opts})
    res = mesh.spawn("repro_torch.launch.island:train_steps",
                     mesh.make_pod_layout(shape[0] * shape[1], "cpu"),
                     shape, cases)
    return {n: [r[i] for r in res] for i, n in enumerate(GROUPS[shape])}


def _serve_ranks():
    """The (2, 2) ranks' prefill and decode logits of both configs."""
    cases = []
    for name in SERVE:
        _, cfg, _, jp, _, _ = _case(name)
        rng = np.random.default_rng(4)
        cases.append({"cfg": cfg, "params": jp,
                      "tokens": rng.integers(0, cfg.vocab_size, (B, S)),
                      "next": rng.integers(0, cfg.vocab_size, (B, 3))})
    res = mesh.spawn("repro_torch.launch.island:serve_steps",
                     mesh.make_pod_layout(4, "cpu"), (2, 2), cases)
    return cases, res[0]


@pytest.fixture(scope="module")
def results():
    for name in CASES:          # the JAX params, made once, before threads
        _case(name)
    with ThreadPoolExecutor(len(GROUPS) + 1) as pool:
        running = {shape: pool.submit(_ranks, shape) for shape in GROUPS}
        serving = pool.submit(_serve_ranks)
        want = _jax_steps()
        return want, {shape: f.result() for shape, f in running.items()}, \
            serving.result()


@pytest.mark.parametrize("shape,name", [(s, n) for s, ns in GROUPS.items()
                                        for n in ns],
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else x)
def test_moe_sharded_step_matches_jax_unsharded(results, shape, name):
    want, got, _ = results
    got = got[shape][name]
    want_loss, want_params, want_m = want[shape, name]
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=RTOL,
                               atol=ATOL)
    FC.assert_tree_close(got[0]["params"], want_params, RTOL, ATOL,
                         "params ")
    m = FC.flat(want_m)
    for path, x in FC.flat(got[0]["m"]).items():
        top = np.abs(m[path]).max()
        assert np.abs(x - m[path]).max() <= M_REL * MB * top, (path, top)
    # TP's collectives on every mesh, FSDP's where data has two ranks
    ops = {op for op, _ in got[0]["collectives"]}
    assert ops >= {"all-gather", "all-reduce"}, ops
    if shape[0] > 1:
        assert "reduce-scatter" in ops, ops
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"] and "params" not in r
        assert sorted(r["collectives"]) == sorted(got[0]["collectives"])


@pytest.mark.parametrize("name", SERVE)
def test_moe_serving_on_island_matches_jax_unsharded(results, name):
    """A prefill of the prompt and three decode steps on the (2, 2) ranks
    (the cache laid out by ``cache_pspec``: MLA's latent ring with its
    features over "model", read by ``mla._latent_decode``) against JAX's
    unsharded prefill and decode at the same grouping: each step's last
    logits at the family tests' atol 1e-5, rtol 1e-4."""
    cases, got = results[2]
    case = cases[SERVE.index(name)]
    ja = _case(name)[0]
    jp = jax.tree.map(jnp.asarray, _case(name)[3])
    S, n = case["tokens"].shape[1], case["next"].shape[1]
    lg, cache = ja.prefill(jp, {"tokens": jnp.asarray(case["tokens"],
                                                      jnp.int32)},
                           cache_len=S + n, groups=2)
    want = [lg[:, -1]]
    for i in range(n):
        lg, cache = ja.decode(jp, cache, jnp.asarray(
            case["next"][:, i:i + 1], jnp.int32), jnp.asarray(S + i,
                                                             jnp.int32),
            groups=2)
        want.append(lg[:, -1])
    logits = got[SERVE.index(name)]["logits"]
    assert len(logits) == len(want)
    for step, (a, b) in enumerate(zip(logits, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")
