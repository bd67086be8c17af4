"""Shared helpers of the ``tests/test_torch_families_*.py`` parity files:
the JAX and port smoke archs of one config from the same parameters, with
every leaf that the JAX init leaves at zero or one (biases, the VLM's
tanh gates, ``conv_b``, ``dt_bias``, norm scales, ``D``) perturbed by
seeded numpy noise, so that a misplaced bias or a dead gate shows; the
batch (tokens and the modality input) from a seed; and the comparisons
of losses, gradients, caches and one DiLoCo round. Not a test module."""
from __future__ import annotations

import functools

import numpy as np
import torch
import jax
import jax.numpy as jnp

from repro.configs.base import DiLoCoConfig as JDCfg
from repro.configs.base import TrainConfig as JTCfg
from repro.core import diloco as JD
from repro.data.pipeline import MarkovMixture as JMarkov
from repro.models import registry as jreg
from repro_torch import convert, tree
from repro_torch.configs.base import DiLoCoConfig, TrainConfig
from repro_torch.core import diloco as TD
from repro_torch.launch.batching import ContinuousBatcher
from repro_torch.models import registry as treg

RTOL, ATOL = 1e-4, 1e-5          # f32 logits, losses, caches, states
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
B, S = 2, 24


def perturb(params_np, seed=0):
    """Every all-zero leaf gets N(0, 0.1²) noise and every all-one leaf
    1 + N(0, 0.1²): the JAX init's zeros and ones hide errors."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if np.all(a == 0):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if np.all(a == 1):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(one, params_np)


def smoke_cfgs(name, **replace):
    jcfg = jreg.get_smoke_arch(name).cfg.replace(**replace)
    tcfg = treg.get_smoke_arch(name).cfg.replace(**replace)
    return jreg.Arch(cfg=jcfg), treg.Arch(cfg=tcfg)


@functools.lru_cache(maxsize=None)
def archs(name, seed=0, **replace):
    """(JAX arch, port arch, JAX params (jnp), port params) of the smoke
    config ``name``, the zero and one leaves perturbed."""
    ja, ta = smoke_cfgs(name, **replace)
    params, _ = ja.init(jax.random.PRNGKey(seed))
    np_params = perturb(jax.tree.map(np.asarray, params), seed)
    return (ja, ta, jax.tree.map(jnp.asarray, np_params),
            convert.params_from_numpy(np_params, device="cpu"))


def batch_np(cfg, seed=1, b=B, s=S):
    """Tokens and, for the cross-attention families, the modality input
    (N(0, 0.1²), as the servers draw it) as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patches"] = (0.1 * rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model))).astype(np.float32)
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def close(got, want, what, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def flat(t) -> dict:
    """{path: numpy leaf} of a JAX or port tree (dicts and tuples)."""
    return {tuple(str(e[1]) for e in path):
            np.asarray(leaf.detach().numpy() if torch.is_tensor(leaf)
                       else leaf)
            for path, leaf in tree.flatten_with_path(t)}


def assert_tree_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """Every leaf of ``got`` (port) against ``want`` (JAX): int leaves
    exactly, the rest within the tolerances; the same paths."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for path, a in g.items():
        assert a.shape == w[path].shape, (what, path)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, w[path], err_msg=f"{what}{path}")
        else:
            close(a, w[path], f"{what}{path}", rtol, atol)


def loss_and_grads(name, **replace):
    """((JAX loss, aux, grads), (port loss, aux, grads)) of the smoke
    config on one seeded batch."""
    ja, ta, jp, tp = archs(name, **replace)
    b = batch_np(ja.cfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: ja.loss(p, to_jax(b)), has_aux=True)(jp)
    tp = tree.map(lambda t: t.detach().clone().requires_grad_(), tp)
    tl, tm = ta.loss(tp, to_torch(b))
    tl.backward()
    # a leaf the loss never reads (command-r's ln2) has no grad: JAX's is 0
    grads = tree.map(lambda t: torch.zeros_like(t) if t.grad is None
                     else t.grad, tp)
    return (jl, jm["aux"], jg), (tl, tm["aux"], grads)


def check_loss_and_grads(name, **replace):
    (jl, ja_, jg), (tl, ta_, tg) = loss_and_grads(name, **replace)
    close(tl, jl, "loss")
    close(ta_, ja_, "aux")
    assert_tree_close(tg, jg, GRAD_RTOL, GRAD_ATOL, "grad")


def check_prefill_decode(name, steps=3, **replace):
    """Prefill a seeded batch in both packages (logits and every cache
    leaf), then decode ``steps`` tokens, each package from the JAX cache
    of the step before."""
    ja, ta, jp, tp = archs(name, **replace)
    b = batch_np(ja.cfg, seed=2, s=20)
    clen = 20 + steps
    jl, jc = ja.prefill(jp, to_jax(b), cache_len=clen)
    with torch.no_grad():
        tl, tc = ta.prefill(tp, to_torch(b), cache_len=clen)
    close(tl, jl, "prefill logits")
    assert_tree_close(tc, jc, what="prefill cache")
    rng = np.random.default_rng(3)
    for step in range(steps):
        nxt = rng.integers(0, ja.cfg.vocab_size, (B, 1)).astype(np.int32)
        tc = cache_from_jax(jc)
        jl, jc = ja.decode(jp, jc, jnp.asarray(nxt),
                           jnp.asarray(20 + step, jnp.int32))
        with torch.no_grad():
            tl, tc = ta.decode(tp, tc, torch.from_numpy(nxt).long(),
                               20 + step)
        close(tl, jl, f"decode {step} logits")
        assert_tree_close(tc, jc, what=f"decode {step} cache")


def cache_from_jax(jc):
    return convert.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                    device="cpu")


def _jax_state_np(state):
    s = jax.tree.map(np.asarray, state)
    return {"global_params": s.global_params,
            "outer_state": {"buf": s.outer_state.buf,
                            "buf2": s.outer_state.buf2,
                            "count": s.outer_state.count},
            "replica_params": s.replica_params,
            "inner_state": {"m": s.inner_state.m, "v": s.inner_state.v,
                            "count": s.inner_state.count},
            "outer_t": s.outer_t, "inner_steps_done": s.inner_steps_done}


def check_round(name, k=2, H=2, b=2, s=16):
    """One k=2, H=2 DiLoCo round of each package from one state, on the
    tokens the JAX sampler draws: every leaf of the state after it."""
    ja, ta, jp, _ = archs(name)
    tcfg = dict(inner_lr=1e-3, warmup_steps=2, total_steps=8)
    sampler = JMarkov(vocab_size=ja.cfg.vocab_size, k=k, seed=0)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, H)            # the round's draws
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, b, s))(keys), 0, 1)[:k])
    jstate0 = JD.init_state(jp, JDCfg(k=k, H=H))
    jrnd = JD.make_round(lambda p, bt: ja.loss(p, bt),
                         sampler.sample_all_shards, JDCfg(k=k, H=H),
                         JTCfg(**tcfg), batch_size=b, seq_len=s)
    jstate, _ = jrnd(jstate0, key)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate0),
                                     device="cpu")
    flat_toks = torch.from_numpy(toks).long().reshape(k, H * b, s)
    rnd = TD.make_round(lambda p, bt: ta.loss(p, bt),
                        lambda g, bb, ss: flat_toks,
                        DiLoCoConfig(k=k, H=H), TrainConfig(**tcfg),
                        batch_size=b, seq_len=s)
    state, _ = rnd(state, None)
    got = dict(tree.paths(convert.state_to_numpy(state)))
    want = dict(tree.paths(_jax_state_np(jstate)))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def serve_engines(name, prompts, gens, *, slots=2, cache_len=64,
                  page_size=16, **replace):
    """The port's paged and contiguous engines on the same requests:
    ({paged: [tokens per request]}, {paged: engine})."""
    _, ta, _, tp = archs(name, **replace)
    outs, engines = {}, {}
    for paged in (False, True):
        eng = ContinuousBatcher(ta, tp, slots=slots, cache_len=cache_len,
                                paged=paged, page_size=page_size)
        rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        done = eng.run_until_drained()
        outs[paged] = [done[r] for r in rids]
        engines[paged] = eng
    return outs, engines


def check_paged_equals_contiguous(name, **replace):
    """Paged = contiguous bit for bit, and each request equals its greedy
    decode alone, through admissions that reuse slots (5 requests, 2
    slots)."""
    from repro_torch.launch.serve import greedy_decode
    _, ta, _, tp = archs(name, **replace)
    rng = np.random.default_rng(5)
    lengths, gens = [12, 7, 19, 5, 9], [6, 1, 4, 8, 5]
    prompts = [rng.integers(0, ta.cfg.vocab_size, n) for n in lengths]
    outs, engines = serve_engines(name, prompts, gens, **replace)
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    for out, p, g in zip(outs[True], prompts, gens):
        alone = greedy_decode(ta, tp, np.asarray(p)[None], gen=g).numpy()[0]
        np.testing.assert_array_equal(out, alone)
    assert engines[True].prefills == 5
