"""The MoE family (``olmoe_1b_7b``: 64 → smoke 4 experts top-2, qk-norm)
against the JAX package at smoke width: ``_topk_iterative`` on ties,
``apply_moe`` with and without drops (``capacity_factor`` 0.5: the
dropped assignments and the outputs), shared experts, loss and
gradients (the aux loss summed over the layers), prefill and decode, one
k=2, H=2 DiLoCo round, and the port's paged engine against its
contiguous one.

Tolerances: f32, atol 1e-5, rtol 1e-4 (gradients atol 1e-6, rtol 1e-4);
expert choices and dropped sets exactly."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import families_common as FC  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

torch.set_num_threads(2)
NAME = "olmoe_1b_7b"


def test_topk_iterative_keeps_the_first_index_on_ties():
    probs = np.array([[[0.3, 0.3, 0.2, 0.2], [0.1, 0.4, 0.4, 0.1]]],
                     np.float32)
    jv, ji = JMOE._topk_iterative(jnp.asarray(probs), 3)
    tv, ti = TMOE._topk_iterative(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0, 0].tolist() == [0, 1, 2] and ti[0, 1].tolist() == [1, 2, 0]


def _moe_case(cf, shared, seed=0):
    ja, _, jp, tp = FC.archs(NAME)
    cfg = ja.cfg.replace(capacity_factor=cf,
                         n_shared_experts=1 if shared else 0)
    rng = np.random.default_rng(seed)
    jm = {k: v[0] for k, v in jp["stack0"]["moe"].items()}
    tm = {k: v[0] for k, v in tp["stack0"]["moe"].items()}
    if shared:
        D, Fs = cfg.d_model, cfg.moe_d_ff
        sp = {"w_up": rng.standard_normal((D, Fs)) * 0.05,
              "w_gate": rng.standard_normal((D, Fs)) * 0.05,
              "w_down": rng.standard_normal((Fs, D)) * 0.05}
        sp = {k: v.astype(np.float32) for k, v in sp.items()}
        jm["shared"] = {k: jnp.asarray(v) for k, v in sp.items()}
        tm["shared"] = {k: torch.from_numpy(v) for k, v in sp.items()}
    x = rng.standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    return cfg, jm, tm, x


@pytest.mark.parametrize("cf,shared,groups", [(4.0, False, 1),
                                              (0.5, False, 1),
                                              (0.5, True, 1),
                                              (0.5, False, 4)])
def test_apply_moe_matches_jax(cf, shared, groups):
    """Outputs and aux, and at capacity_factor 0.5 the dropped set: every
    group's (T, K) keep mask exactly."""
    cfg, jm, tm, x = _moe_case(cf, shared)
    kept = {}

    def spy(pkg, fn):
        def wrapped(*a):
            out = fn(*a)
            kept.setdefault(pkg, []).append(np.asarray(
                out[2].numpy() if torch.is_tensor(out[2]) else out[2]))
            return out
        return wrapped

    jy, jaux = JMOE.apply_moe(jm, jnp.asarray(x), cfg, groups=groups)
    orig = TMOE._dispatch_group
    TMOE._dispatch_group = spy("torch", orig)
    try:
        ty, taux = TMOE.apply_moe(tm, torch.from_numpy(x), cfg,
                                  groups=groups)
    finally:
        TMOE._dispatch_group = orig
    FC.close(ty, jy, "moe out")
    FC.close(taux, jaux, "aux")
    # the JAX keep mask, recomputed from its own router on the same input
    G = np.gcd(x.shape[0] * x.shape[1], groups)
    xf = jnp.asarray(x).reshape(G, -1, cfg.d_model)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xf, jm["router"]), -1)
    tp_, ti_ = JMOE._topk_iterative(probs, cfg.top_k)
    tp_ = tp_ / jnp.maximum(tp_.sum(-1, keepdims=True), 1e-9)
    C = JMOE._capacity(xf.shape[1], cfg.top_k, cfg.n_experts,
                       cfg.capacity_factor)
    want = np.asarray(jax.vmap(lambda a, b, c: JMOE._dispatch_group(
        a, b, c, cfg.n_experts, C)[2])(xf, tp_, ti_))
    np.testing.assert_array_equal(np.stack(kept["torch"]), want)
    if cf < 1:
        assert not want.all(), "capacity 0.5 must drop assignments"
    else:
        assert want.all()


def test_loss_and_grads_match_jax():
    FC.check_loss_and_grads(NAME)


def test_loss_and_grads_with_drops_match_jax():
    FC.check_loss_and_grads(NAME, capacity_factor=0.5)


def test_prefill_and_decode_match_jax():
    FC.check_prefill_decode(NAME)


def test_round_matches_jax():
    FC.check_round(NAME)


def test_paged_equals_contiguous():
    FC.check_paged_equals_contiguous(NAME)
