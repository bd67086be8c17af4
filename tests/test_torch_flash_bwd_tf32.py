"""The arithmetic of the flash-attention backward kernels on the CPU.

``csrc/flash_attention.cu`` computes dq (``flash_dq_kernel``) and dk, dv
(``flash_dkv_kernel``) on the tensor cores in split TF32 (``flash_tf32``
says how an operand is split and how an MMA rounds; the backward hands
the small part to the MMA as it is, truncated). The kernels run only on
the card; this file emulates their five products as they issue them:

- the score products sum each 16-wide slice of d from a fresh
  accumulator (k-steps d = 16·kp + 4t + {0, 1}, then + {2, 3}) and add
  the slices in f32: S = (q·scale)·Kᵀ and dP = dO·Vᵀ in dq (q or dO the
  MMA's A operand), Sᵀ = K·(q·scale)ᵀ and dPᵀ = V·dOᵀ in dk/dv (K or V
  the A operand, which orders the split terms the other way);
- P = exp(S − lse) where visible, else 0, and dS = P∘(dP − Δ);
- dq sums each 32-key tile's dS·K from zero (four k-steps of 8 keys) and
  adds it to the running f32 sum, then scales by ``scale``; dk/dv sums
  each 32-query tile's Pᵀ·dO and dSᵀ·(q·scale) from zero and adds it to
  one running sum per kv head, over its query heads in order and their
  query tiles.

The kernels' exponential (``__expf``, within a few ulp) is emulated by
``torch.exp``. Held to the kernels' backward tolerance, 5e-4·(1 + |want|)
on dq, dk and dv, against the port's plain versions (``ref.flash_bwd_dq``,
``ref.flash_bwd_dkv``) and against the gradient of the JAX package's
reference attention (``kernels/ref.py``, through ``jax.vjp``), on the
same numpy inputs. With scores of std 8 the plain versions' own float32
rounding puts them 1.5e-5·(1 + |want|) from their float64 result at d
128 (``test_plain_f32_error_large_logits`` bounds it by 3e-5), a
thirtieth of the tolerance, so float32 stays the reference there (the
emulation is 2.9e-5 from it, 3.1e-5 from float64).

A single TF32 pass misses the tolerance by far with scores of std 8
(1.9e-2 from float64), which shows that the check tells that design
apart. One long accumulator chain (S and dP over all of d, dq over all
keys, dk and dv over all queries) stays inside it: its round-toward-zero
drift takes the error from 3.1e-5 to 7.3e-5 of float64 there, a seventh
of the backward's tolerance, so
``test_tile_chains_beat_one_chain_large_logits`` checks only that the
kernels' short chains are closer to float64 than the long one.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flash_tf32 import mma, tf32_trunc  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)
TOL = 5e-4        # the backward kernels' tolerance (tests/test_torch_cuda.py)
TILE = 32         # dq's key tile and dk/dv's query tile: one chain each
MMA_K = 8         # the products one m16n8k8 MMA sums


def _mma(c, a, b, passes):
    return mma(c, a, b, passes, small=tf32_trunc)


def _score(a, b, passes, chains):
    """a (.., m, d) times b (.., n, d) transposed, as the kernels' score
    products: per 16-wide slice of d two k-steps from a fresh accumulator
    (``chains="tile"``), the slices added in f32; or one chain over all
    of d (``"one"``). ``a`` is the MMA's A operand."""
    d = a.shape[-1]
    s = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    c = s
    for kp in range(0, d, 16):
        if chains == "tile":
            c = torch.zeros_like(s)
        for half in (0, 2):
            idx = [kp + 4 * t + half + e for t in range(4) for e in (0, 1)]
            c = _mma(c, a[..., idx], b[..., idx].transpose(-1, -2), passes)
        s = s + c if chains == "tile" else c
    return s


def _tiles(x, m, passes, chains, acc=None):
    """acc + x @ m over the shared dimension n (x (.., r, n), m (.., n,
    d)), as the kernels' second products: each 32-wide tile of n summed
    from zero in four k-steps and added to the running f32 sum
    (``chains="tile"``); or one chain over all of n (``"one"``)."""
    n = x.shape[-1]
    if acc is None:
        acc = torch.zeros(x.shape[:-1] + m.shape[-1:])
    for t0 in range(0, n, TILE):
        c = torch.zeros_like(acc) if chains == "tile" else acc
        for j in range(t0, min(t0 + TILE, n), MMA_K):
            xs, ms = x[..., j:j + MMA_K], m[..., j:j + MMA_K, :]
            if xs.shape[-1] < MMA_K:          # the tile's zero-filled rows
                pad = MMA_K - xs.shape[-1]
                xs = torch.nn.functional.pad(xs, (0, pad))
                ms = torch.nn.functional.pad(ms, (0, 0, 0, pad))
            c = _mma(c, xs, ms, passes)
        acc = acc + c if chains == "tile" else c
    return acc


def emulated_bwd(q, k, v, lse, do, delta, *, causal, window, passes=3,
                 chains="tile"):
    """(dq, dk, dv) as the kernels compute them, in the kernel layout (q,
    dO (B, H, Sq, d); k, v (B, G, Sk, d); lse, delta (B, H, Sq))."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    rep = H // G
    scale = ref.f32(d ** -0.5)
    qs = q * scale
    kh, vh = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    ok = ref.flash_visible(Sq, Sk, causal=causal, window=window)
    lse_, dl = lse[..., None], delta[..., None]

    # dq: S and dP with query rows as M, dS·K over 32-key tiles
    s = _score(qs, kh, passes, chains)
    dp = _score(do, vh, passes, chains)
    p = torch.where(ok, torch.exp(s - lse_), 0.0)
    dq = _tiles(p * (dp - dl), kh, passes, chains) * scale

    # dk/dv: Sᵀ and dPᵀ with key rows as M, then over 32-query tiles,
    # one running sum per kv head across its query heads
    st = _score(kh, qs, passes, chains)
    dpt = _score(vh, do, passes, chains)
    pt = torch.where(ok.T, torch.exp(st - lse_.transpose(-1, -2)), 0.0)
    dst = pt * (dpt - dl.transpose(-1, -2))
    dk = dv = None
    for r in range(rep):
        heads = slice(r, H, rep)
        dv = _tiles(pt[:, heads], do[:, heads], passes, chains, dv)
        dk = _tiles(dst[:, heads], qs[:, heads], passes, chains, dk)
    return dq, dk, dv


def _inputs(B, H, G, Sq, Sk, d, amp, seed):
    """q, k, v, dO from numpy; q and k times ``amp`` (scores of std
    amp²)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape
                   in ((B, H, Sq, d), (B, G, Sk, d), (B, G, Sk, d),
                       (B, H, Sq, d)))
    return (torch.from_numpy(q * np.float32(amp)),
            torch.from_numpy(k * np.float32(amp)), torch.from_numpy(v),
            torch.from_numpy(do))


def _residuals(q, k, v, do, opts):
    """lse and Δ = rowsum(dO∘O) from the plain forward, as the backward
    kernels receive them."""
    o, lse = ref.flash_fwd_lse(q, k, v, **opts)
    return lse, (do * o).sum(-1)


def _plain(q, k, v, lse, do, delta, opts):
    return (ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts),
            *ref.flash_bwd_dkv(q, k, v, lse, do, delta, **opts))


def _worst(got, want):
    return max(float(((g.double() - w.double()).abs()
                      / (1 + w.double().abs())).max())
               for g, w in zip(got, want))


LARGE = 8 ** 0.5      # q and k scaled so that the scores have std 8
# name: B, H, G, (Sq, Sk), d, causal, window, amp
CASES = {
    "causal_d128": (1, 2, 2, (192, 192), 128, True, 0, 1.0),
    "window_d64": (1, 2, 2, (320, 320), 64, True, 96, 1.0),
    "gqa2_d64": (1, 4, 2, (192, 192), 64, True, 0, 1.0),
    "gqa4_window_d128": (1, 4, 1, (160, 160), 128, True, 72, 1.0),
    "bidirectional_d128": (2, 2, 1, (160, 160), 128, False, 0, 1.0),
    "ragged_d64": (1, 2, 1, (100, 229), 64, True, 0, 1.0),
    "large_logits_d128": (1, 2, 1, (384, 384), 128, True, 0, LARGE),
    "large_logits_d64": (1, 2, 2, (320, 320), 64, True, 0, LARGE),
}


def _case(name):
    B, H, G, (Sq, Sk), d, causal, window, amp = CASES[name]
    q, k, v, do = _inputs(B, H, G, Sq, Sk, d, amp, seed=Sq + Sk + d)
    opts = dict(causal=causal, window=window)
    return (q, k, v, do), opts


@pytest.mark.parametrize("name", list(CASES))
def test_split_tf32_backward_within_tolerance(name):
    """The kernels' three-product split on their accumulators keeps dq, dk
    and dv within 5e-4·(1 + |want|) of the plain versions and of the JAX
    reference's gradient."""
    (q, k, v, do), opts = _case(name)
    lse, delta = _residuals(q, k, v, do, opts)
    got = emulated_bwd(q, k, v, lse, do, delta, **opts)
    assert _worst(got, _plain(q, k, v, lse, do, delta, opts)) <= TOL, name
    # the JAX oracle (float32) in the model layout (B, S, H, d)
    model = lambda t: jnp.asarray(t.transpose(1, 2).numpy())
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c, **opts),
                     model(q), model(k), model(v))
    want = [torch.from_numpy(np.array(g)).transpose(1, 2)
            for g in vjp(model(do))]
    assert _worst(got, want) <= TOL, name


def _large_case():
    """The d 128 large-score case: inputs, options, residuals and the
    float64 truth of its gradients."""
    (q, k, v, do), opts = _case("large_logits_d128")
    lse, delta = _residuals(q, k, v, do, opts)
    return (q, k, v, lse, do, delta), opts


def _plain64(q, k, v, lse, do, delta, opts):
    """The plain backward's maths on float64 copies (its residuals too)."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    o, lse = ref.flash_fwd_lse(q, k, v, **opts)
    delta = (do * o).sum(-1)
    scale = d ** -0.5
    kh, vh = (t.repeat_interleave(H // G, dim=1) for t in (k, v))
    ok = ref.flash_visible(Sq, Sk, **opts)
    p = torch.where(ok, torch.exp(q * scale @ kh.transpose(-1, -2)
                                  - lse[..., None]), 0.0)
    ds = p * (do @ vh.transpose(-1, -2) - delta[..., None])
    dq = ds @ kh * scale
    dk = (ds.transpose(-1, -2) @ (q * scale)).view(B, G, H // G, Sk, d)
    dv = (p.transpose(-1, -2) @ do).view(B, G, H // G, Sk, d)
    return dq, dk.sum(2), dv.sum(2)


def test_plain_f32_error_large_logits():
    """With scores of std 8 the float32 plain versions sit within
    3e-5·(1 + |want|) of their float64 result (1.5e-5): a seventeenth of
    the tolerance at most, so the emulation is held to them in float32."""
    args, opts = _large_case()
    err = _worst(_plain(*args, opts), _plain64(*args, opts))
    assert err <= 3e-5, err


def test_single_tf32_pass_fails_large_logits():
    """One TF32 pass (operands rounded once, one product) misses the
    tolerance by far where the scores are large."""
    args, opts = _large_case()
    got = emulated_bwd(*args, **opts, passes=1)
    assert _worst(got, _plain64(*args, opts)) > 10 * TOL


def test_tile_chains_beat_one_chain_large_logits():
    """One accumulator chain for each product (S and dP over all of d,
    the second products over all keys or queries) drifts further from
    float64 than the kernels' short chains where the scores are large."""
    args, opts = _large_case()
    want = _plain64(*args, opts)
    tile = _worst(emulated_bwd(*args, **opts), want)
    one = _worst(emulated_bwd(*args, **opts, chains="one"), want)
    assert tile < one, (tile, one)
