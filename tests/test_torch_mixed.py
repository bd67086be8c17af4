"""The port's mixed-precision replicas against the JAX package's.

Two bf16 policies: the mixed (bfloat16 params and moments, float32
master) and the pure (bfloat16, bfloat16). Inputs are made with numpy
from a seed and handed to both packages; bf16 leaves cross as uint16 bit
patterns (``convert``), since the port imports no ml_dtypes.

Tolerances, and why:

* The AdamW kernels' plain versions follow ``_adamw_kernel``'s operation
  order ((1-b2)·g, then times g); the JAX oracle squares g first, and the
  Pallas kernel in interpret mode is compiled by XLA, which contracts
  multiply-adds and rewrites (m/c1)/d as m/(c1·d). With hyperparameters
  whose products are exact in float32 (b1 = 7/8, b2 = 15/16, weight decay
  1/8, lr 2^-12: a bf16 operand times them needs at most 12 significant
  bits) the multiplication orders all round the same: the plain versions
  equal the JAX oracle bit for bit, and the interpret-mode kernel bit for
  bit in m and v; its rewritten division moves the updated params by at
  most one ulp of their dtype. At the trainer's hyperparameters they are
  held to one bf16 ulp (and the f32 master to rtol 1e-6, atol 1e-7, the
  f32 kernel tests' tolerance).
* A round is held to JAX ``kernel_mode="ref"``: float32 leaves (globals,
  outer momentum, masters) at atol 1e-5, rtol 1e-4, as the f32 round
  tests. bf16 leaves (replicas, m, v) at H ulps of the leaf's largest
  magnitude: the gradients reach the optimizer rounded to bf16 from f32
  sums taken in another order, so a step can round one ulp apart (the
  reference differs from itself by one ulp after one round between its
  ``ref`` and ``interpret`` modes), and m and v carry that over H steps.
  Under the pure policy the globals are updated from bf16 replicas, so
  they also carry up to outer_lr·(1+μ) < 2 such ulps.
* With pruning, an outer-gradient entry that lies within rounding of its
  row's threshold is kept by one package and zeroed by the other; at most
  0.1% of a leaf's entries may differ by more than the tolerance. The
  outer step alone, given identical inputs, is held at the f32 tolerance.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.kernels import fused_adamw as JFA  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import precision as jprec  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.kernels import fused_adamw as TFA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import precision as tprec  # noqa: E402

torch.set_num_threads(2)
SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPES = [(17,), (1000,), (37, 53), (4, 16, 130), (1,), ()]
EXACT = dict(lr=2.0 ** -12, c1=0.19, c2=0.0975, b1=0.875, b2=0.9375,
             eps=1e-8, weight_decay=0.125)
TRAINER = dict(lr=3e-4, c1=0.19, c2=0.0975, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1)
POLICIES = {"mixed": ("bfloat16", "float32"), "pure": ("bfloat16",
                                                       "bfloat16")}
B, S = 2, 16
TCFG = dict(inner_lr=1e-3, warmup_steps=2, total_steps=16)


def _np(x):
    """A JAX array or a tensor as numpy; bf16 as uint16 bits."""
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _f32(a):
    """numpy leaf (bf16 as uint16 bits) -> float32."""
    return convert.bf16_to_f32(a) if a.dtype == np.uint16 else a


def _key(bits):
    """bf16 bits -> integers ordered as the values (+0 and -0 both 0)."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _bf16_ulps(a, b):
    return int(np.abs(_key(a) - _key(b)).max(initial=0))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    g, m, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    return g, m, np.abs(v), w


def _bf(a):
    return jnp.asarray(a, jnp.bfloat16)


def _tb(a):
    """numpy float32 -> torch bf16 with the bits JAX rounds to."""
    return convert.tensor_from_numpy(np.asarray(_bf(a)), device="cpu")


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_adamw_mixed_bitwise(shape):
    """Exact-product hyperparameters: the plain mixed step equals the JAX
    oracle bit for bit, and the Pallas kernel in interpret mode as the
    module docstring says."""
    g, m, v, w = _inputs(shape, sum(shape) + 1)
    jin = (_bf(g), _bf(m), _bf(v), jnp.asarray(w))
    want_ref = jref.fused_adamw_mixed(*jin, **EXACT)
    want_pallas = JFA.fused_adamw_mixed(*jin, interpret=True, **EXACT)
    got = TFA.fused_adamw_mixed(_tb(g), _tb(m), _tb(v), torch.from_numpy(w),
                                **EXACT)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32]
    for a, r in zip(got, want_ref):
        assert a.shape == tuple(shape)
        np.testing.assert_array_equal(_np(a), _np(r))
    _assert_interpret(got, want_pallas, params_at=(0, 3))


def _assert_interpret(got, want, params_at):
    """Against the interpret-mode kernel: m and v bit for bit, the params
    outputs (positions ``params_at``) within one ulp of their dtype."""
    for i, (a, c) in enumerate(zip(got, want)):
        a, c = _np(a), _np(c)
        if i not in params_at:
            np.testing.assert_array_equal(a, c)
        elif a.dtype == np.uint16:
            assert _bf16_ulps(a, c) <= 1
        else:
            np.testing.assert_array_max_ulp(a, c, maxulp=1)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_adamw_bf16_bitwise(shape):
    """The pure-bf16 step (bf16 p, g, m, v), as the previous test."""
    g, m, v, p = _inputs(shape, sum(shape) + 2)
    jin = (_bf(p), _bf(g), _bf(m), _bf(v))
    want_ref = jref.fused_adamw(*jin, **EXACT)
    want_pallas = JFA.fused_adamw(*jin, interpret=True, **EXACT)
    got = TFA.fused_adamw(_tb(p), _tb(g), _tb(m), _tb(v), **EXACT)
    for a, r in zip(got, want_ref):
        assert a.dtype == torch.bfloat16 and a.shape == tuple(shape)
        np.testing.assert_array_equal(_np(a), _np(r))
    _assert_interpret(got, want_pallas, params_at=(0,))


@pytest.mark.parametrize("kind", ["mixed", "bf16"])
def test_fused_adamw_low_precision_trainer_hyperparameters(kind):
    """At the trainer's hyperparameters: one bf16 ulp against the oracle
    and the interpret-mode kernel (1e-7 absolute where m's sum cancels),
    the f32 master at the f32 tolerance."""
    shape = (300, 301)
    g, m, v, w = _inputs(shape, 5)
    if kind == "mixed":
        jin = (_bf(g), _bf(m), _bf(v), jnp.asarray(w))
        wants = (jref.fused_adamw_mixed(*jin, **TRAINER),
                 JFA.fused_adamw_mixed(*jin, interpret=True, **TRAINER))
        got = TFA.fused_adamw_mixed(_tb(g), _tb(m), _tb(v),
                                    torch.from_numpy(w), **TRAINER)
    else:
        jin = (_bf(w), _bf(g), _bf(m), _bf(v))
        wants = (jref.fused_adamw(*jin, **TRAINER),
                 JFA.fused_adamw(*jin, interpret=True, **TRAINER))
        got = TFA.fused_adamw(_tb(w), _tb(g), _tb(m), _tb(v), **TRAINER)
    for want in wants:
        for a, b in zip(got, want):
            a, b = _np(a), _np(b)
            if a.dtype == np.uint16:
                # one bf16 ulp, or 1e-7 where b1·m + (1-b1)·g cancels and
                # the f32 orders differ in the last bits of a tiny sum
                np.testing.assert_allclose(_f32(a), _f32(b), rtol=2.0 ** -7,
                                           atol=1e-7)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_fused_adamw_in_place_and_checks():
    g, m, v, w = _inputs((37, 53), 3)
    ts = [_tb(g), _tb(m), _tb(v), torch.from_numpy(w.copy())]
    want = TFA.fused_adamw_mixed(*ts, **TRAINER)
    p = torch.empty_like(ts[0])
    TFA.fused_adamw_mixed_(p, *ts, **TRAINER)
    for a, b in zip((p, ts[1], ts[2], ts[3]), want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):       # mixed takes bf16 g, m, v
        TFA.fused_adamw_mixed(*(torch.zeros(3),) * 4, **TRAINER)
    with pytest.raises(TypeError):       # one storage dtype throughout
        TFA.fused_adamw(torch.zeros(3), *(torch.zeros(
            3, dtype=torch.bfloat16),) * 3, **TRAINER)
    before = dict(TFA.launches)
    TFA.fused_adamw(*(torch.ones(4, dtype=torch.bfloat16),) * 4, **TRAINER)
    assert TFA.launches == before


def _grad_tree(params, seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: _grad_tree(v, seed + 1 + i, dtype) if isinstance(v, dict)
            else np.asarray(jnp.asarray(rng.standard_normal(v.shape)
                                        .astype(np.float32) * 0.01, dtype))
            for i, (k, v) in enumerate(sorted(params.items()))}


def _assert_trees(got, want, *, bf16_ulps=1, rtol=1e-6, atol=1e-7):
    got, want = dict(tree.paths(got)), dict(tree.paths(want))
    assert sorted(got) == sorted(want)
    for path, b in want.items():
        a, b = _np(got[path]), _np(b)
        assert a.dtype == b.dtype, path
        if a.dtype == np.uint16:
            assert _bf16_ulps(a, b) <= bf16_ulps, path
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=path)


@pytest.mark.parametrize("policy", ["mixed", "pure"])
@pytest.mark.parametrize("mode", ["ref", "auto"])
def test_adamw_init_update_match_jax(policy, mode):
    """``adamw.init``/``update`` over three steps against the JAX
    optimizer in ``ref`` mode. The port's ``ref`` mode keeps the JAX
    order (bias corrections by numpy's float32 pow, XLA's may differ by an
    ulp); ``auto`` runs the kernels' plain versions. One bf16 ulp; the
    f32 master within 4e-6: a moment one bf16 ulp apart moves an update
    of size lr = 1e-3 by up to lr·2^-8 = 3.9e-6."""
    pol_names = POLICIES[policy]
    jarch = jreg.get_smoke_arch("diloco_150m")
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(0))[0])
    jpol, tpol = jprec.make_policy(*pol_names), tprec.make_policy(*pol_names)
    jp = jprec.cast_tree(jax.tree.map(jnp.asarray, params), jpol.param_dtype)
    js = jadamw.init(jax.tree.map(jnp.asarray, params), policy=jpol)
    tp = tprec.cast_tree(convert.params_from_numpy(params, device="cpu"),
                         tpol.param_dtype)
    ts = tadamw.init(convert.params_from_numpy(params, device="cpu"),
                     policy=tpol)
    assert (ts.master is None) == (policy == "pure")
    for leaf in tree.leaves(ts.m) + tree.leaves(ts.v):
        assert leaf.dtype == torch.bfloat16 and not leaf.any()
    if ts.master is not None:
        assert all(t.dtype == torch.float32 for t in tree.leaves(ts.master))
    for step in range(3):
        grads = _grad_tree(params, 10 * step, jpol.param_dtype)
        jp, js = jadamw.update(jax.tree.map(jnp.asarray, grads), js, jp,
                               lr=1e-3, mode="ref", policy=jpol)
        tp, ts = tadamw.update(convert.params_from_numpy(grads,
                                                         device="cpu"),
                               ts, tp, lr=1e-3, mode=mode, policy=tpol)
    assert ts.count == int(js.count) == 3
    _assert_trees(tp, jp)
    _assert_trees(ts.m, js.m)
    _assert_trees(ts.v, js.v)
    if policy == "mixed":
        _assert_trees(ts.master, js.master, atol=4e-6)
    # the update refuses a state and a policy that disagree
    with pytest.raises(ValueError, match="master"):
        tadamw.update(tp, ts, tp, lr=1e-3,
                      policy=tprec.make_policy(*POLICIES["pure"])
                      if policy == "mixed" else
                      tprec.make_policy(*POLICIES["mixed"]))


def test_clip_by_global_norm_bf16_matches_jax():
    """bf16 grads: the norm in f32, the scaled grads rounded to bf16 once
    (an in-place bf16 product would round the scale first)."""
    rng = np.random.default_rng(4)
    grads = {"a": rng.standard_normal((40, 30)).astype(np.float32),
             "b": rng.standard_normal((77,)).astype(np.float32)}
    jg = {k: _bf(v) for k, v in grads.items()}
    want, wnorm = jadamw.clip_by_global_norm(jg, 1.0)
    got, norm = tadamw.clip_by_global_norm(
        {k: _tb(v) for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in grads:
        assert got[k].dtype == torch.bfloat16
        assert _bf16_ulps(_np(got[k]), _np(want[k])) <= 1


def _jax_state_np(state):
    s = jax.tree.map(_np, state)
    inner = {"m": s.inner_state.m, "v": s.inner_state.v,
             "count": s.inner_state.count}
    if s.inner_state.master is not None:
        inner["master"] = s.inner_state.master
    return {"global_params": s.global_params,
            "outer_state": {"buf": s.outer_state.buf,
                            "buf2": s.outer_state.buf2,
                            "count": s.outer_state.count},
            "replica_params": s.replica_params, "inner_state": inner,
            "outer_t": s.outer_t, "inner_steps_done": s.inner_steps_done}


@pytest.mark.parametrize("policy", ["mixed", "pure"])
def test_init_state_layout_matches_jax(policy):
    """Replicas and moments at bf16, masters (mixed only) and globals at
    f32, every leaf a fresh buffer, the same bits as the JAX state."""
    pdt, mdt = POLICIES[policy]
    jarch = jreg.get_smoke_arch("diloco_150m")
    params = jarch.init(jax.random.PRNGKey(2))[0]
    want = _jax_state_np(JD.init_state(params, JDCfg(
        k=3, param_dtype=pdt, master_dtype=mdt)))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    st = TD.init_state(tparams, DiLoCoConfig(k=3, param_dtype=pdt,
                                             master_dtype=mdt))
    for leaf in tree.leaves(st.replica_params) + tree.leaves(
            st.inner_state.m) + tree.leaves(st.inner_state.v):
        assert leaf.dtype == torch.bfloat16 and leaf.shape[0] == 3
    assert (st.inner_state.master is None) == (policy == "pure")
    ptrs = [t.data_ptr() for t in tree.leaves(tparams)]
    groups = [st.global_params, st.replica_params, st.inner_state.m,
              st.inner_state.v] + ([st.inner_state.master]
                                   if policy == "mixed" else [])
    seen = [t.data_ptr() for g in groups for t in tree.leaves(g)]
    assert len(set(seen)) == len(seen) and not set(seen) & set(ptrs)
    for t in tree.leaves(st.global_params):
        assert t.dtype == torch.float32
    got = convert.state_to_numpy(st)
    for (path, a), (wpath, b) in zip(tree.paths(got), tree.paths(want)):
        assert path == wpath
        np.testing.assert_array_equal(a, b, err_msg=path)


def _rounds(pdt, mdt, frac, *, k=2, H=4, mode="auto", arch="diloco_150m"):
    """One JAX round (kernel_mode ref) and one port round from the same
    state and tokens. Returns (jax state np, port state np, jax metrics,
    port metrics)."""
    jarch = jreg.get_smoke_arch(arch)
    tarch = treg.get_smoke_arch(arch)
    params, _ = jarch.init(jax.random.PRNGKey(1))
    pol = dict(param_dtype=pdt, master_dtype=mdt)
    jd = JDCfg(k=k, H=H, prune_frac=frac, **pol)
    jstate0 = JD.init_state(params, jd)
    sampler = JMarkov(vocab_size=jarch.cfg.vocab_size, k=k, seed=0)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, H)
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(keys), 0, 1)[:k])
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b),
                         sampler.sample_all_shards, jd,
                         JTCfg(**TCFG, **pol), batch_size=B, seq_len=S)
    jstate, jm = jrnd(jstate0, key)
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate0),
                                     device="cpu")
    flat = torch.from_numpy(toks).long().reshape(k, H * B, S)
    rnd = TD.make_round(lambda p, b: tarch.loss(p, b), lambda g, b, s: flat,
                        DiLoCoConfig(k=k, H=H, prune_frac=frac,
                                     kernel_mode=mode, **pol),
                        TrainConfig(kernel_mode=mode, **TCFG, **pol),
                        batch_size=B, seq_len=S)
    state, tm = rnd(state, None)
    return _jax_state_np(jstate), convert.state_to_numpy(state), jm, tm


def _assert_round_close(got, want, *, H, pure, max_flipped=0.0):
    """The module docstring's round tolerances (``check.mismatch_shares``);
    ``max_flipped`` is the share of a leaf's entries allowed outside them
    (pruning decisions)."""
    for path, share in check.mismatch_shares(got, want, H=H,
                                             pure=pure).items():
        assert share <= max_flipped, (path, share)


@pytest.mark.parametrize("pdt,mdt,frac", [
    ("bfloat16", "float32", 0.0), ("bfloat16", "float32", 0.5),
    ("bfloat16", "bfloat16", 0.0)])
def test_round_matches_jax(pdt, mdt, frac):
    """k=2, H=4: every leaf of the state after one round, against JAX
    kernel_mode ref (tolerances in the module docstring)."""
    H = 4
    want, got, jm, tm = _rounds(pdt, mdt, frac, H=H)
    _assert_round_close(got, want, H=H, pure=mdt == "bfloat16",
                        max_flipped=1e-3 if frac > 0 else 0.0)
    for name in ("inner_loss", "outer_gnorm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, atol=1e-5)
    if frac > 0:
        assert 0.0 < float(tm["prune_density"]) <= 0.5


def test_ref_mode_round_matches_jax():
    """The port's ref mode (the JAX ref-mode maths) under the mixed
    policy holds the same tolerances."""
    want, got, _, _ = _rounds("bfloat16", "float32", 0.0, H=2, mode="ref")
    _assert_round_close(got, want, H=2, pure=False)


def test_outer_step_deltas_master_against_master():
    """Outer deltas are taken from the f32 masters, not the bf16 working
    copies: masters moved by less than a bf16 ulp move the new globals as
    the JAX outer step does (identical inputs, pruning included: f32
    tolerance), and differently from a step on the working copies."""
    k = 2
    jarch = jreg.get_smoke_arch("diloco_150m")
    params = jarch.init(jax.random.PRNGKey(5))[0]
    dcfg = dict(k=k, param_dtype="bfloat16", master_dtype="float32",
                prune_frac=0.5)
    js = JD.init_state(params, JDCfg(**dcfg))
    rng = np.random.default_rng(0)
    moved = jax.tree.map(lambda w: w + jnp.asarray(
        rng.standard_normal(w.shape).astype(np.float32) * 1e-4),
        js.inner_state.master)
    js = js._replace(inner_state=js.inner_state._replace(master=moved))
    jnew, _ = JD.outer_step(js, JDCfg(**dcfg))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                  device="cpu")
    tnew, tm = TD.outer_step(ts, DiLoCoConfig(**dcfg))
    want = jax.tree.map(np.asarray, jnew.global_params)
    for (path, a), (_, b) in zip(tree.paths(tnew.global_params),
                                 tree.paths(want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7,
                                   err_msg=path)
    assert float(tm["prune_density"]) <= 0.5
    # replicas adopt the new globals rounded to bf16, masters at f32
    for g, r, w in zip(tree.leaves(tnew.global_params),
                       tree.leaves(tnew.replica_params),
                       tree.leaves(tnew.inner_state.master)):
        assert torch.equal(r[0], g.to(torch.bfloat16))
        assert torch.equal(w[1], g)
    # the same step from the working copies gives other globals
    ts2 = convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                   device="cpu")
    ts2 = ts2._replace(inner_state=ts2.inner_state._replace(master=None))
    other, _ = TD.outer_step(ts2, DiLoCoConfig(k=k, prune_frac=0.5))
    assert not all(torch.equal(a, b) for a, b in zip(
        tree.leaves(other.global_params), tree.leaves(tnew.global_params)))


def test_convert_round_trips_mixed_state():
    """A JAX mixed state -> the port -> numpy gives the JAX state's bits
    (bf16 leaves as uint16), and back to the port unchanged."""
    jarch = jreg.get_smoke_arch("diloco_150m")
    params = jarch.init(jax.random.PRNGKey(6))[0]
    js = JD.init_state(params, JDCfg(k=2, param_dtype="bfloat16",
                                     master_dtype="float32"))
    want = _jax_state_np(js)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                  device="cpu")
    got = convert.state_to_numpy(ts)
    assert [p for p, _ in tree.paths(got)] == [p for p, _ in
                                               tree.paths(want)]
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    # numpy (bf16 as uint16) -> the port again: the same tensors
    again = convert.params_from_numpy(got["replica_params"], device="cpu")
    for a, b in zip(tree.leaves(again), tree.leaves(ts.replica_params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_bf16_param_grads_match_jax():
    """bf16 params under compute_dtype float32: the loss and every
    gradient (bf16, the weight casts' and the embedding gather's) against
    JAX's, within one bf16 ulp of the leaf's largest gradient: both
    compute in f32 and round once to bf16; the gather's gradient sums a
    token's rows in f32 before that rounding."""
    jarch = jreg.get_smoke_arch("diloco_150m")
    tarch = treg.get_smoke_arch("diloco_150m")
    params = jarch.init(jax.random.PRNGKey(7))[0]
    jp = jprec.cast_tree(params, jnp.bfloat16)
    toks = np.random.default_rng(1).integers(
        0, jarch.cfg.vocab_size, (B, S)).astype(np.int32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jarch.loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    tp = convert.params_from_numpy(jax.tree.map(_np, jp), device="cpu")
    req = tree.map(lambda t: t.requires_grad_(True), tp)
    loss, _ = tarch.loss(req, {"tokens": torch.from_numpy(toks).long()})
    tg = torch.autograd.grad(loss, tree.leaves(req))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for (path, want), got in zip(tree.paths(jax.tree.map(_np, jg)), tg):
        assert got.dtype == torch.bfloat16, path
        w = _f32(want)
        atol = check.ulp_bf16(float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(_f32(_np(got)), w, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("policy", ["mixed", "pure"])
def test_single_worker_step_matches_jax(policy):
    """Two single-worker steps (the pretraining stage) under each bf16
    policy against JAX's, from the same params and tokens."""
    pdt, mdt = POLICIES[policy]
    jarch = jreg.get_smoke_arch("diloco_150m")
    tarch = treg.get_smoke_arch("diloco_150m")
    params = jarch.init(jax.random.PRNGKey(8))[0]
    pol = dict(param_dtype=pdt, master_dtype=mdt)
    jpol = jprec.make_policy(pdt, mdt)
    jstep = JD.make_single_worker_step(lambda p, b: jarch.loss(p, b),
                                       JTCfg(**TCFG, **pol), donate=False)
    jopt = jadamw.init(params, policy=jpol)
    jw = jprec.cast_tree(params, jpol.param_dtype, fresh=True)
    tpol = tprec.make_policy(pdt, mdt)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tstep = TD.make_single_worker_step(lambda p, b: tarch.loss(p, b),
                                       TrainConfig(**TCFG, **pol))
    topt = tadamw.init(tparams, policy=tpol)
    tw = tprec.cast_tree(tparams, tpol.param_dtype, fresh=True)
    rng = np.random.default_rng(2)
    for i in range(2):
        toks = rng.integers(0, jarch.cfg.vocab_size, (B, S)).astype(
            np.int32)
        jw, jopt, jm = jstep(jw, jopt, {"tokens": jnp.asarray(toks)},
                             jnp.asarray(i))
        tw, topt, tm = tstep(tw, topt,
                             {"tokens": torch.from_numpy(toks).long()}, i)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    want = {"params": jax.tree.map(_np, jw),
            "m": jax.tree.map(_np, jopt.m), "v": jax.tree.map(_np, jopt.v)}
    got = {"params": convert.params_to_numpy(tw),
           "m": convert.params_to_numpy(topt.m),
           "v": convert.params_to_numpy(topt.v)}
    if policy == "mixed":
        want["master"] = jax.tree.map(_np, jopt.master)
        got["master"] = convert.params_to_numpy(topt.master)
    _assert_round_close(got, want, H=2, pure=False)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.mark.parametrize("flags", [
    ["--param-dtype", "bfloat16", "--master-dtype", "float32",
     "--prune-frac", "0.5"],
    ["--param-dtype", "bfloat16", "--master-dtype", "bfloat16"]])
def test_train_cli_low_precision_on_cpu(tmp_path, flags):
    """The trainer with the new flags on --device cpu, pretraining
    included: finite losses, and the pruned share recorded per round."""
    out = tmp_path / "run.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--k", "2", "--H", "2", "--rounds", "2", "--batch", "2", "--seq",
         "32", "--pretrain-steps", "2", "--log-every", "1", "--eval-batch",
         "2", "--out", str(out), *flags],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    hist = json.loads(out.read_text())["history"]
    assert [r["phase"] for r in hist] == ["pretrain"] * 2 + ["diloco"] * 2
    for r in hist:
        assert math.isfinite(r["inner_loss"]) and math.isfinite(r["val_loss"])
    pruned = "--prune-frac" in flags
    for r in hist[2:]:
        assert ("prune_density" in r) == pruned
        if pruned:
            assert 0.0 < r["prune_density"] <= 0.5


def test_adamw_update_tree_mixed_in_place():
    """The tree-level mixed update writes every output over its input."""
    rng = np.random.default_rng(9)
    mk = lambda: {"a": rng.standard_normal((5, 7)).astype(np.float32),
                  "b": {"c": rng.standard_normal((33,)).astype(np.float32)}}
    w, g, m, v = mk(), mk(), mk(), mk()
    v = {"a": np.abs(v["a"]), "b": {"c": np.abs(v["b"]["c"])}}
    tb = lambda t: tree.map(lambda a: _tb(a), t)
    P, G, M, V = tb(w), tb(g), tb(m), tb(v)
    W = convert.params_from_numpy(w, device="cpu")
    c1, c2 = tops.adamw_scalars(1, 0.9, 0.95)
    want = [TFA.fused_adamw_mixed(gg, mm, vv, ww, lr=1e-3, c1=c1, c2=c2)
            for gg, mm, vv, ww in zip(*(tree.leaves(t) for t in (G, M, V, W)))]
    out = tops.adamw_update_tree_mixed(P, G, M, V, W, lr=1e-3, count=1)
    assert out[0] is P and out[3] is W
    for leaf, outs in enumerate(want):
        for t, o in zip((P, M, V, W), outs):
            assert torch.equal(tree.leaves(t)[leaf], o)


@pytest.mark.parametrize("policy", ["f32", "mixed", "pure"])
def test_replica_carry_bytes_match_jax(policy):
    """``precision.tree_bytes`` of a state's per-replica carry (working
    params, moments and masters): 12, 10 and 6 B per parameter under the
    f32, mixed and pure policies, as the JAX package counts them."""
    pdt, mdt = POLICIES.get(policy, ("float32", "float32"))
    jarch = jreg.get_smoke_arch("diloco_150m")
    params = jarch.init(jax.random.PRNGKey(0))[0]
    k = 2
    js = JD.init_state(params, JDCfg(k=k, param_dtype=pdt, master_dtype=mdt))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js),
                                  device="cpu")
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    carry = lambda prec, st: sum(prec.tree_bytes(t) for t in (
        st.replica_params, st.inner_state.m, st.inner_state.v,
        st.inner_state.master))
    assert carry(tprec, ts) == carry(jprec, js) == k * n * {
        "f32": 12, "mixed": 10, "pure": 6}[policy]
    assert tprec.tree_bytes(None) == 0
