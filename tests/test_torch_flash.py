"""The port's flash attention against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does), inside its model too: there the JAX
``ops.flash_attention`` is called in ``interpret`` mode, because its
off-TPU ``auto``/``ref`` path hands kernel-layout (B, H, S, d) arrays to
the model-layout oracle ``ref.flash_attention`` and so attends across
heads (``test_ref_mode_is_the_jax_oracle`` shows the port does not copy
that). The port runs on the CPU, where its kernel wrapper computes the
kernels' maths with the plain versions of ``kernels/ref.py`` (the CUDA
kernels themselves are held against those on the card, in
``tests/test_torch_cuda.py``). Tolerances:

  * forward o and lse: rtol = atol = 2e-5, the JAX package's for its
    forward kernel (tiles of 64 against whole rows: another summation
    order in the softmax);
  * backward dq, dk, dv: rtol = atol = 5e-4, the JAX package's for its
    backward kernels;
  * the attention block: rtol = atol = 1e-5, as for the port's other
    attention paths (``tests/test_torch_model.py``);
  * a DiLoCo round: atol 1e-5, rtol 1e-4 on every state leaf, as in
    ``tests/test_torch_diloco.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.kernels import flash_attention as FK  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.sharding.spec import unbox  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.kernels import flash_attention as TFK  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
FWD_TOL, BWD_TOL = 2e-5, 5e-4
BLOCK = 64       # the JAX kernels' tiles here, as in its own tests

# B, H, G, S, d, causal, window (the kinds of the JAX ATTN_CASES and
# BWD_CASES, kept small for interpret mode)
CASES = [
    (2, 4, 2, 128, 64, True, 0),        # GQA
    (1, 2, 1, 192, 64, True, 64),       # sliding window
    (1, 4, 2, 128, 64, False, 0),       # bidirectional
    (2, 2, 1, 96, 32, True, 0),         # not block-aligned
    (1, 4, 4, 128, 128, True, 0),       # the 400m head dim
]


def _inputs(B, H, G, S, d, seed, n=4):
    """q, k, v, dO as float32 numpy arrays in the kernel layout."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, S, d), (B, G, S, d), (B, G, S, d), (B, H, S, d))
    return [np.asarray(rng.standard_normal(s), np.float32)
            for s in shapes[:n]]


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _jax_opts(d, causal, window):
    return dict(causal=causal, window=window, scale=d ** -0.5, bq=BLOCK,
                bk=BLOCK, q_offset=0, interpret=True)


@pytest.mark.parametrize("B,H,G,S,d,causal,window", CASES)
def test_forward_matches_jax_kernels(B, H, G, S, d, causal, window):
    """``flash_fwd_lse`` against ``_fwd_lse`` (o and lse) and
    ``flash_fwd`` against ``flash_attention``, both in interpret mode."""
    q, k, v = _inputs(B, H, G, S, d, S + d, n=3)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o, want_lse = FK._fwd_lse(jq, jk, jv, **_jax_opts(d, causal,
                                                           window))
    want_plain = FK.flash_attention(jq, jk, jv, causal=causal,
                                    window=window, block_q=BLOCK,
                                    block_k=BLOCK, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = TFK.flash_fwd_lse(tq, tk, tv, causal=causal, window=window)
    assert o.shape == (B, H, S, d) and lse.shape == (B, H, S)
    _close(o, want_o, FWD_TOL)
    _close(lse, want_lse, FWD_TOL)
    _close(TFK.flash_fwd(tq, tk, tv, causal=causal, window=window),
           want_plain, FWD_TOL)


@pytest.mark.parametrize("B,H,G,S,d,causal,window", CASES)
def test_backward_matches_jax_kernels(B, H, G, S, d, causal, window):
    """``flash_bwd`` against ``_bwd`` in interpret mode, from the same
    residuals (the JAX forward's o and lse) and the same dO."""
    q, k, v, do = _inputs(B, H, G, S, d, 3 * S + d)
    opts = _jax_opts(d, causal, window)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = FK._fwd_lse(jq, jk, jv, **opts)
    want = FK._bwd((jq, jk, jv, o, lse), jdo, **opts)
    got = TFK.flash_bwd(*map(torch.from_numpy, (q, k, v)),
                        torch.from_numpy(np.array(o)),
                        torch.from_numpy(np.array(lse)),
                        torch.from_numpy(do), causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, BWD_TOL)


@pytest.mark.parametrize("B,H,G,S,d,causal,window", CASES[:4])
def test_autograd_matches_jax_vjp(B, H, G, S, d, causal, window):
    """``ops.flash_attention`` in the model layout, forward and
    ``torch.autograd.grad``, against ``jax.vjp`` of
    ``make_flash_attention_vjp`` (interpret mode)."""
    q, k, v, do = _inputs(B, H, G, S, d, 5 * S + d)
    fa = FK.make_flash_attention_vjp(causal=causal, window=window,
                                     block_q=BLOCK, block_k=BLOCK,
                                     interpret=True)
    want_o, vjp = jax.vjp(fa, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    # the model layout (B, S, H, d): the same arrays, heads and rows swapped
    leaves = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                               ).requires_grad_(True) for a in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=causal, window=window)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(
        np.ascontiguousarray(do.transpose(0, 2, 1, 3))))
    _close(out.transpose(1, 2), want_o, FWD_TOL)
    for g, w in zip(grads, want):
        _close(g.transpose(1, 2), w, BWD_TOL)


@pytest.mark.parametrize("B,H,G,S,d,causal,window", CASES[:4])
def test_ref_mode_is_the_jax_oracle(B, H, G, S, d, causal, window):
    """The port's ``ref`` mode is the JAX full-softmax oracle
    ``kernels/ref.py:flash_attention``, in the model layout."""
    q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
               for a in _inputs(B, H, G, S, d, 7 * S + d, n=3))
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)),
                                causal=causal, window=window)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window, mode="ref")
    _close(got, want, FWD_TOL)


def test_modes_and_launches_on_cpu():
    """``kernel`` on CPU tensors and the TPU modes raise; ``auto`` and
    ``ref`` on the CPU launch no kernel, forward or backward."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous()
               for a in _inputs(1, 2, 2, 128, 64, 0, n=3))
    for mode in ("kernel", "pallas", "interpret", "bogus"):
        with pytest.raises(ValueError):
            tops.flash_attention(q, k, v, mode=mode)
    before = dict(TFK.launches)
    for mode in ("auto", "ref"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tops.flash_attention(*leaves, mode=mode)
        torch.autograd.grad(out.sum(), leaves)
        with torch.no_grad():
            tops.flash_attention(q, k, v, mode=mode)
    assert TFK.launches == before


# ---------------------------------------------------------------------------
# the model's dispatch and a whole round
# ---------------------------------------------------------------------------

def _flash_branches(monkeypatch):
    """Make the JAX model's flash branch run its Pallas kernels in
    interpret mode (see the module docstring), and count the calls of
    each package's flash branch (the JAX count is per trace)."""
    taken = {"jax": 0, "torch": 0}
    jax_fa, torch_fa = jops.flash_attention, tops.flash_attention

    def jax_interpret(*args, **kw):
        taken["jax"] += 1
        return jax_fa(*args, **{**kw, "mode": "interpret"})

    def torch_spy(*args, **kw):
        taken["torch"] += 1
        return torch_fa(*args, **kw)
    monkeypatch.setattr(jops, "flash_attention", jax_interpret)
    monkeypatch.setattr(tops, "flash_attention", torch_spy)
    return taken


def _flash_cfgs(**changes):
    """The diloco_400m smoke config in both packages, with ``changes``."""
    jcfg = jreg.get_smoke_arch("diloco_400m").cfg.replace(**changes)
    tcfg = treg.get_smoke_arch("diloco_400m").cfg.replace(**changes)
    return jcfg, tcfg


# head_dim, seq, use_pallas, whether both models take the flash branch
DISPATCH = [(128, 128, True, True), (128, 96, True, False),
            (64, 128, True, False), (128, 128, False, False)]


@pytest.mark.parametrize("hd,S,use_pallas,flash", DISPATCH)
def test_apply_attention_dispatch_matches_jax(monkeypatch, hd, S,
                                              use_pallas, flash):
    """The port's attention block takes the flash branch on exactly the
    shapes where the JAX block does, and agrees with it there and
    elsewhere: output and the gradients of params and input."""
    jcfg, tcfg = _flash_cfgs(use_pallas=use_pallas, head_dim=hd)
    taken = _flash_branches(monkeypatch)
    params = jax.tree.map(np.asarray, unbox(
        JL.init_attention(jax.random.PRNGKey(2), jcfg))[0])
    rng = np.random.default_rng(S + hd)
    x = np.asarray(rng.standard_normal((2, S, jcfg.d_model)), np.float32)
    dy = np.asarray(rng.standard_normal((2, S, jcfg.d_model)), np.float32)
    pos = jnp.arange(S)

    def jfn(p, x):
        return JL.apply_attention(p, x, jcfg, positions=pos)[0]

    want, vjp = jax.vjp(jfn, tree.map(jnp.asarray, params), jnp.asarray(x))
    want_grads = vjp(jnp.asarray(dy))
    tp = tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    tx = torch.from_numpy(x).requires_grad_(True)
    got, _ = TL.apply_attention(tp, tx, tcfg, positions=torch.arange(S))
    grads = torch.autograd.grad(got, tree.leaves(tp) + [tx],
                                torch.from_numpy(dy))
    assert taken == {"jax": int(flash), "torch": int(flash)}
    _close(got, want, 1e-5)
    want_leaves = [a for _, a in tree.paths(jax.tree.map(
        np.asarray, want_grads[0]))] + [np.asarray(want_grads[1])]
    for g, w in zip(grads, want_leaves):
        _close(g, w, 1e-5)


def test_flash_round_matches_jax(monkeypatch):
    """The slice as a whole: a k=2, H=2 DiLoCo round of the diloco_400m
    smoke config with head_dim 128 and use_pallas at seq 128 (the flash
    branch in both packages), from the same state and tokens: every leaf
    of the state after the round."""
    taken = _flash_branches(monkeypatch)
    k, H, B, S = 2, 2, 2, 128
    jcfg, tcfg = _flash_cfgs(use_pallas=True, head_dim=128)
    jarch = jreg.get_smoke_arch("diloco_400m")
    tarch = treg.get_smoke_arch("diloco_400m")
    params, _ = jarch.init(jax.random.PRNGKey(1), cfg=jcfg)
    sampler = JMarkov(vocab_size=jcfg.vocab_size, k=k, seed=0)
    key = jax.random.PRNGKey(3)
    # the tokens the JAX round draws from ``key``: (k, H, B, S)
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(
            jax.random.split(key, H)), 0, 1)[:k])
    train = dict(inner_lr=1e-3, warmup_steps=2, total_steps=8)
    jd = JDCfg(k=k, H=H)
    jstate0 = JD.init_state(params, jd)
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b, cfg=jcfg),
                         sampler.sample_all_shards, jd, JTCfg(**train),
                         batch_size=B, seq_len=S)
    jstate, _ = jrnd(jstate0, key)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate0),
                                     device="cpu")
    flat = torch.from_numpy(toks).long().reshape(k, H * B, S)
    rnd = TD.make_round(lambda p, b: tarch.loss(p, b, cfg=tcfg),
                        lambda g, b, s: flat,
                        DiLoCoConfig(k=k, H=H), TrainConfig(**train),
                        batch_size=B, seq_len=S)
    state, _ = rnd(state, None)
    # 2 layers, each run forward twice (remat) in every replica step
    assert taken["jax"] > 0 and taken["torch"] == 2 * 2 * k * H
    got = dict(tree.paths(convert.state_to_numpy(state)))
    s = jax.tree.map(np.asarray, jstate)
    want = {"global_params": s.global_params,
            "replica_params": s.replica_params,
            "outer_state": {"buf": s.outer_state.buf},
            "inner_state": {"m": s.inner_state.m, "v": s.inner_state.v}}
    want = tree.paths(want)
    assert len(want) > 0
    for path, w in want:
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
