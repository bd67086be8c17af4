"""The hybrid family (``zamba2_2_7b``: Mamba2 layers and one SHARED
attention + MLP block invoked once a group) against the JAX package at
smoke width: ``_causal_conv`` with its tail, ``ssd_chunked`` over whole
chunks, over chunks of 1 (T < chunk) and as one chunk of T (T no
multiple of the chunk), ``ssd_decode_step`` (both also with bf16 x, B
and C against float32 states, as at bf16 compute), loss and gradients (the
tied block's summed over 2 and 3 invocations, under the group
checkpoint), prefill and decode, one k=2, H=2 DiLoCo round, the
streaming fragment partition, and the port's paged engine against its
contiguous one.

Tolerances: f32, atol 1e-5, rtol 1e-4 (gradients atol 1e-6, rtol 1e-4);
fragment masks exactly. With bf16 inputs: y within 1e-2 of max|y| (y is
rounded to bf16, whose half-ulp is 2^-9 of a value, after the port's
C·B scores are rounded to bf16; measured 0.5 %), the float32 state
within 1e-5 of max|state|."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import families_common as FC  # noqa: E402
from repro.core import fragments as JF  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro_torch.core import fragments as TF  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402

torch.set_num_threads(2)
NAME = "zamba2_2_7b"


def _ssd_inputs(T, seed=0, B=2, H=3, P=4, N=5, dt_shift=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, Bm, Cm = f(B, T, H, P), f(B, T, N), f(B, T, N)
    dt = np.log1p(np.exp(f(B, T, H) + dt_shift)).astype(np.float32)
    A = -np.exp(0.5 * f(H)).astype(np.float32)
    Dp = f(H)
    return x, dt, A, Bm, Cm, Dp


@pytest.mark.parametrize("T,chunk", [(32, 8), (5, 8), (20, 8), (16, 16)])
def test_ssd_chunked_matches_jax(T, chunk):
    args = _ssd_inputs(T, seed=T)
    jy, js = JSSM.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, ts = TSSM.ssd_chunked(*map(torch.from_numpy, args), chunk)
    FC.close(ty, jy, "y")
    FC.close(ts, js, "final state")


def test_ssd_decode_step_and_conv_tail_match_jax():
    x, dt, A, Bm, Cm, Dp = _ssd_inputs(1, seed=3)
    state = np.random.default_rng(4).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    jy, js = JSSM.ssd_decode_step(*map(jnp.asarray, (x, dt, A, Bm, Cm, Dp,
                                                     state)))
    ty, ts = TSSM.ssd_decode_step(*map(torch.from_numpy, (x, dt, A, Bm, Cm,
                                                          Dp, state)))
    FC.close(ty, jy, "decode y")
    FC.close(ts, js, "decode state")
    rng = np.random.default_rng(5)
    xc, w, b = (rng.standard_normal(s).astype(np.float32)
                for s in ((2, 6, 7), (4, 7), (7,)))
    tail = rng.standard_normal((2, 3, 7)).astype(np.float32)
    for t in (None, tail):
        jy, jt = JSSM._causal_conv(*map(jnp.asarray, (xc, w, b)),
                                   None if t is None else jnp.asarray(t))
        ty, tt = TSSM._causal_conv(*map(torch.from_numpy, (xc, w, b)),
                                   None if t is None else torch.from_numpy(t))
        FC.close(ty, jy, "conv y")
        FC.close(tt, jt, "conv tail")


def _bf16(*arrays):
    """The same bf16 values as JAX and as torch arrays (both round to
    nearest even)."""
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


def _close_to_max(got, want, frac, what):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=frac * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("T,chunk", [(64, 16), (24, 8)])
def test_ssd_chunked_bf16_x_B_C_match_jax(T, chunk):
    """bf16 x, B and C, float32 dt, A and D, as ``apply_mamba2`` hands
    them over at bf16 compute. dt is small (softplus(N(0, 1) − 2)), so a
    chunk's state still carries into the next chunks' outputs and the
    B·x and C·state contractions both show in y."""
    x, dt, A, Bm, Cm, Dp = _ssd_inputs(T, seed=T, dt_shift=-2.0)
    (jx, jB, jC), (tx, tB, tC) = _bf16(x, Bm, Cm)
    jy, js = JSSM.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                              jnp.asarray(Dp), chunk)
    ty, ts = TSSM.ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A),
                              tB, tC, torch.from_numpy(Dp), chunk)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    _close_to_max(ty, jy, 1e-2, "y")
    _close_to_max(ts, js, 1e-5, "final state")


def test_ssd_decode_step_bf16_x_B_C_matches_jax():
    x, dt, A, Bm, Cm, Dp = _ssd_inputs(1, seed=6)
    state = np.random.default_rng(7).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    (jx, jB, jC), (tx, tB, tC) = _bf16(x, Bm, Cm)
    jy, js = JSSM.ssd_decode_step(jx, jnp.asarray(dt), jnp.asarray(A), jB,
                                  jC, jnp.asarray(Dp), jnp.asarray(state))
    ty, ts = TSSM.ssd_decode_step(tx, torch.from_numpy(dt),
                                  torch.from_numpy(A), tB, tC,
                                  torch.from_numpy(Dp),
                                  torch.from_numpy(state))
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    _close_to_max(ty, jy, 1e-2, "decode y")
    _close_to_max(ts, js, 1e-5, "decode state")


def test_loss_and_grads_match_jax():
    FC.check_loss_and_grads(NAME)


@pytest.mark.parametrize("layers", [4, 6])
def test_shared_block_grads_sum_over_invocations(layers):
    """2 and 3 groups: the tied block's gradient is the sum over its
    invocations, recomputed under each group's checkpoint."""
    (jl, _, jg), (tl, _, tg) = FC.loss_and_grads(NAME, n_layers=layers)
    FC.close(tl, jl, "loss")
    FC.assert_tree_close(tg, jg, FC.GRAD_RTOL, FC.GRAD_ATOL, "grad")
    assert float(tg["shared"]["attn"]["wq"].abs().sum()) > 0


def test_prefill_and_decode_match_jax():
    FC.check_prefill_decode(NAME)


def test_prefill_and_decode_over_two_groups_match_jax():
    FC.check_prefill_decode(NAME, n_layers=4)


def test_round_matches_jax():
    FC.check_round(NAME)


@pytest.mark.parametrize("P", [2, 3])
def test_fragment_partition_matches_jax(P):
    """``shared`` sits with the unstacked leaves (depth 1), as in JAX."""
    ja, _, jp, tp = FC.archs(NAME, n_layers=6)
    want = JF.partition_params(jp, P)
    got = TF.partition_params(tp, P)
    assert got.sizes == tuple(want.sizes)
    assert got.region_sizes == tuple(tuple(r) for r in want.region_sizes)
    for gm, wm in zip(got.masks, want.masks):
        FC.assert_tree_close(gm, wm, 0, 0, "mask")


def test_paged_equals_contiguous():
    FC.check_paged_equals_contiguous(NAME)
