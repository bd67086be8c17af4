"""FSDP×TP within an island for the hybrid family (zamba2: Mamba2's SSD
mixer and the tied SHARED attention + MLP block) on real ranks against
JAX's unsharded step (``tests/test_torch_island.py`` holds the dense and
cross-attention families, ``tests/test_torch_island_moe.py`` MoE/MLA).

Each rank runs its own heads of the scan (their z, x and dt columns of
``in_proj``, which JAX's layout cuts into contiguous blocks that do not
follow the heads: at this width 548 columns, 274 a rank, the boundary
between z and x at 256 inside rank 0's block) with B and C whole, the
gated RMSNorm's squares summed over "model", ``out_proj``'s rows its
own; the SHARED block is one param leaf read once a group, its weights
gathered and its gradient reduce-scattered at each invocation. The
zamba2 smoke config at 4 layers (two groups of two Mamba2 layers and the
SHARED block: it runs twice), chunks of 8 over 16 tokens (two chunks, so
that the recurrence between them runs), every all-zero and all-one leaf
perturbed, runs one AdamW step of the dry run's train step at 2
microbatches on (data 2, model 2) and (data 1, model 2) gloo ranks, held
to JAX's unsharded ``build_train_step`` on the same params, state and
batch. The bounds are the dense family's: the loss and every param at
atol 1e-5, rtol 1e-4; the first moments leaf by leaf within 2⁻⁷ of the
leaf's largest per microbatch. The config is also served on (2, 2): a
prefill and three decode steps (``island.serve_steps``: the state laid
out with N over "model" and the conv tail's channels over "model", as
``cache_pspec`` lays them) against JAX's unsharded prefill and decode,
the logits at atol 1e-5, rtol 1e-4.
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
ARCH = "zamba2_2_7b"
MODEL = {"n_layers": 4, "ssm_chunk": 8}
GROUPS = ((2, 2), (1, 2))


def _case():
    """(JAX arch, the port's cfg, numpy params, numpy v, batch), both
    packages without remat."""
    ja, ta, jp, _ = FC.archs(ARCH, **MODEL)
    assert ja.cfg.shared_attn_every == 2 and ja.cfg.n_layers == 4
    batch = FC.batch_np(ja.cfg, seed=3, b=B, s=S)
    ja = type(ja)(cfg=ja.cfg.replace(remat=False))
    jp = jax.tree.map(np.asarray, jp)
    return ja, ta.cfg.replace(remat=False), jp, _second_moments(jp), batch


def _jax_step():
    """JAX's unsharded step: (loss, params, first moments)."""
    jd = dryrun_common.import_jax_dryrun()
    ja, _, jp, v, batch = _case()
    step = jax.jit(jd.build_train_step(ja, ja.cfg, groups=1,
                                       microbatches=MB))
    p, m, _, _, loss = step(jp, jax.tree.map(jnp.zeros_like, jp), v,
                            jnp.zeros((), jnp.int32), FC.to_jax(batch))
    return float(loss), jax.tree.map(np.asarray, p), \
        jax.tree.map(np.asarray, m)


def _ranks(shape):
    _, cfg, jp, v, batch = _case()
    res = mesh.spawn("repro_torch.launch.island:train_steps",
                     mesh.make_pod_layout(shape[0] * shape[1], "cpu"),
                     shape, [{"cfg": cfg, "params": jp, "v": v,
                              "batch": batch, "microbatches": MB}])
    return [r[0] for r in res]


def _serve_ranks():
    """The (2, 2) ranks' prefill and decode logits."""
    _, cfg, jp, _, _ = _case()
    rng = np.random.default_rng(4)
    case = {"cfg": cfg, "params": jp,
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "next": rng.integers(0, cfg.vocab_size, (B, 3))}
    res = mesh.spawn("repro_torch.launch.island:serve_steps",
                     mesh.make_pod_layout(4, "cpu"), (2, 2), [case])
    return case, res[0][0]


@pytest.fixture(scope="module")
def results():
    _case()                     # the JAX params, made once, before threads
    with ThreadPoolExecutor(len(GROUPS) + 1) as pool:
        running = {shape: pool.submit(_ranks, shape) for shape in GROUPS}
        serving = pool.submit(_serve_ranks)
        want = _jax_step()
        return want, {shape: f.result() for shape, f in running.items()}, \
            serving.result()


@pytest.mark.parametrize("shape", GROUPS,
                         ids=lambda x: "x".join(map(str, x)))
def test_hybrid_sharded_step_matches_jax_unsharded(results, shape):
    want, got, _ = results
    got = got[shape]
    want_loss, want_params, want_m = want
    np.testing.assert_allclose(got[0]["loss"], want_loss, rtol=RTOL,
                               atol=ATOL)
    FC.assert_tree_close(got[0]["params"], want_params, RTOL, ATOL,
                         "params ")
    m = FC.flat(want_m)
    for path, x in FC.flat(got[0]["m"]).items():
        top = np.abs(m[path]).max()
        assert np.abs(x - m[path]).max() <= M_REL * MB * top, (path, top)
    # TP's collectives on every mesh (the in_proj gathers, B and C, the
    # norm's sums, out_proj's partial sums), FSDP's where data has two
    # ranks; every rank issues the same ones
    ops = {op for op, _ in got[0]["collectives"]}
    assert ops >= {"all-gather", "all-reduce", "reduce-scatter"}, ops
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"] and "params" not in r
        assert sorted(r["collectives"]) == sorted(got[0]["collectives"])


def test_hybrid_serving_on_island_matches_jax_unsharded(results):
    """A prefill of the prompt and three decode steps on the (2, 2) ranks
    against JAX's unsharded prefill and decode: each step's last logits
    at the family tests' atol 1e-5, rtol 1e-4 (the decode reads the state
    and the conv tail where ``cache_pspec`` lays them, and writes them
    back there)."""
    case, got = results[2]
    ja, _, jp, _, _ = _case()
    jp = jax.tree.map(jnp.asarray, jp)
    S_, n = case["tokens"].shape[1], case["next"].shape[1]
    lg, cache = ja.prefill(jp, {"tokens": jnp.asarray(case["tokens"],
                                                      jnp.int32)},
                           cache_len=S_ + n)
    want = [lg[:, -1]]
    for i in range(n):
        lg, cache = ja.decode(jp, cache, jnp.asarray(
            case["next"][:, i:i + 1], jnp.int32), jnp.asarray(S_ + i,
                                                             jnp.int32))
        want.append(lg[:, -1])
    logits = got["logits"]
    assert len(logits) == len(want)
    for step, (a, b) in enumerate(zip(logits, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")
