"""The port's optimizer kernels against the JAX package's.

On the CPU the port's kernel wrappers run their plain PyTorch versions;
these are held against the JAX oracles (``kernels/ref.py``), the Pallas
kernels in interpret mode and the tree-level ops. Tolerance rtol 1e-6,
atol 1e-7: the elementwise operation order is the same, and only XLA's
float32 ``pow`` (in the bias corrections) and its FMA contraction may
move a result by an ulp. The outer deltas and momenta are drawn at a
hundredth of the parameters' scale, as in training: with both operands of
the final subtraction at O(1), one ulp of an operand (2.4e-7 at 2) would
exceed atol on a result that cancels to near zero. The CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` holds them
against the plain versions there.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fused_adamw as JFA  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import outer_nesterov as JON  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fused_adamw as TFA  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import outer_nesterov as TON  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-6, 1e-7
# ragged sizes (17, 37*53: not multiples of 4 or 128), a 1-element and
# a 0-d leaf, and a shape with a stacked-layer lead dim
SHAPES = [(17,), (1000,), (37, 53), (4, 16, 130), (1,), ()]
ADAMW = dict(lr=3e-4, c1=0.19, c2=0.0975, b1=0.9, b2=0.95, eps=1e-8,
             weight_decay=0.1)


def _inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(shape), np.float32)
            for _ in range(n)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_adamw_plain_matches_jax(shape):
    p, g, m, v = _inputs(shape, 4, sum(shape) + 1)
    v = np.asarray(np.abs(v))
    want_ref = jref.fused_adamw(*map(jnp.asarray, (p, g, m, v)), **ADAMW)
    want_pallas = JFA.fused_adamw(*map(jnp.asarray, (p, g, m, v)),
                                  interpret=True, **ADAMW)
    got = TFA.fused_adamw(*map(torch.as_tensor, (p, g, m, v)), **ADAMW)
    for a, b, c in zip(got, want_ref, want_pallas):
        assert a.shape == tuple(shape)
        _close(a, b)
        _close(a, c)


@pytest.mark.parametrize("shape", SHAPES)
def test_outer_nesterov_plain_matches_jax(shape):
    p, d, b = _inputs(shape, 3, sum(shape) + 7)
    d, b = d * np.float32(1e-2), b * np.float32(1e-2)
    want_ref = jref.outer_nesterov(*map(jnp.asarray, (p, d, b)), lr=0.7,
                                   momentum=0.9)
    want_pallas = JON.outer_nesterov(*map(jnp.asarray, (p, d, b)), lr=0.7,
                                     momentum=0.9, interpret=True)
    got = TON.outer_nesterov(*map(torch.as_tensor, (p, d, b)), lr=0.7,
                             momentum=0.9)
    for a, r, c in zip(got, want_ref, want_pallas):
        _close(a, r)
        _close(a, c)


def test_in_place_forms_equal_functional_forms():
    p, g, m, v, d, b = _inputs((37, 53), 6, 3)
    v = np.abs(v)
    ts = [torch.from_numpy(x.copy()) for x in (p, g, m, v)]
    want = TFA.fused_adamw(*ts, **ADAMW)
    TFA.fused_adamw_(*ts, **ADAMW)
    for a, w in zip((ts[0], ts[2], ts[3]), want):
        assert torch.equal(a, w)
    ts = [torch.from_numpy(x.copy()) for x in (p, d, b)]
    want = TON.outer_nesterov(*ts, lr=0.7, momentum=0.9)
    TON.outer_nesterov_(*ts, lr=0.7, momentum=0.9)
    assert torch.equal(ts[0], want[0]) and torch.equal(ts[2], want[1])


def _tree(seed, positive=False):
    xs = _inputs((5, 7), 1, seed) + _inputs((33,), 1, seed + 1) \
        + _inputs((2, 3, 4), 1, seed + 2)
    if positive:
        xs = [np.abs(x) for x in xs]
    return {"b": {"w": xs[0], "s": xs[1]}, "a": xs[2]}


def _tmap(fn, t):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


@pytest.mark.parametrize("count", [1, 7])
def test_adamw_update_tree_matches_jax(count):
    p, g, m, v = _tree(0), _tree(10), _tree(20), _tree(30, positive=True)
    want = jops.adamw_update_tree(*(_tmap(jnp.asarray, t)
                                    for t in (p, g, m, v)),
                                  lr=1e-3, count=count, mode="interpret")
    got = [_tmap(lambda x: torch.from_numpy(x.copy()), t)
           for t in (p, g, m, v)]
    out = tops.adamw_update_tree(*got, lr=1e-3, count=count, mode="auto")
    assert out[0] is got[0]                    # written in place
    for o, w in zip(out, want):
        for key in ("a",):
            _close(o[key], w[key])
        for key in ("w", "s"):
            _close(o["b"][key], w["b"][key])


def test_nesterov_update_tree_matches_jax():
    p, d, b = _tree(1), _tree(2), _tree(3)
    want = jops.nesterov_update_tree(*(_tmap(jnp.asarray, t)
                                       for t in (p, d, b)),
                                     lr=0.7, momentum=0.9, mode="ref")
    got = [_tmap(lambda x: torch.from_numpy(x.copy()), t)
           for t in (p, d, b)]
    tops.nesterov_update_tree(got[0], got[1], got[2], lr=0.7,
                              momentum=0.9, mode="auto")
    for o, w in zip((got[0], got[2]), want):
        _close(o["a"], w["a"])
        _close(o["b"]["w"], w["b"]["w"])


def test_kernel_modes():
    t = {"w": torch.zeros(3)}
    for mode in ("pallas", "interpret", "bogus"):
        with pytest.raises(ValueError):
            tops.nesterov_update_tree(t, t, t, lr=0.7, mode=mode)
    with pytest.raises(ValueError, match="CUDA"):
        tops.adamw_update_tree(t, t, t, t, lr=1e-3, count=1, mode="kernel")
    with pytest.raises(TypeError):
        TFA.fused_adamw(*(torch.zeros(3, dtype=torch.float64),) * 4,
                        **ADAMW)
    with pytest.raises(ValueError):
        TON.outer_nesterov(torch.zeros(4), torch.zeros(3), torch.zeros(4),
                           lr=0.7)


def test_plain_versions_launch_nothing():
    a0, b0 = dict(TFA.launches), TON.launches
    x = torch.ones(10)
    TFA.fused_adamw(x, x, x, x, **ADAMW)
    TON.outer_nesterov_(x.clone(), x, x.clone(), lr=0.7)
    assert (TFA.launches, TON.launches) == (a0, b0)

