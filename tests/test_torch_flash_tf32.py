"""The arithmetic of the flash-attention forward kernel on the CPU.

``csrc/flash_attention.cu`` computes S = (q·scale)·Kᵀ and O += P·V on the
tensor cores in split TF32: each f32 operand x is split into big =
rna(x) and small = rna(x − big), where rna rounds to the nearest tf32
(10 mantissa bits, ties away from zero) as ``cvt.rna.tf32.f32`` does, and
each product is three m16n8k8 MMAs, big·small, small·big, big·big, into
an f32 accumulator. The kernel itself runs only on the card; this file
emulates its MMAs as it issues them:

- rna from the f32 bit pattern (``(bits + 0x1000) & ~0x1fff``);
- each MMA sums its 8 products (exact: two tf32 values multiply exactly)
  and its accumulator, and rounds the sum toward zero to f32, as the
  tensor cores do. The emulation sums exactly before that one rounding,
  so it is kinder than the card, whose alignment of the terms drops bits
  too;
- S sums each 16-wide slice of d from a fresh accumulator (the kernel's
  k-steps: d = 16·kp + 4t + {0, 1}, then + {2, 3}) and adds the slices in
  f32; P·V sums each 32-key tile from zero and folds it into O with the
  softmax correction in one fused multiply-add;
- around them the plain forward's maths: ``ref.flash_fwd_lse``'s masks
  and the kernel's online normalisation over 32-key tiles.

Held to the kernels' forward tolerance, 2e-5·(1 + |want|) on o and lse,
against the port's plain version and the JAX package's reference. Two
designs that the kernel does not use must fall outside it where the
scores are large (std 8), which shows that the check tells them apart:
a single TF32 pass, and one accumulator chain for S over all of d and for
O over all keys (the round-toward-zero error then grows with the chain).
Where the scores are large the plain version runs on float64 copies of
the inputs: there float32's own rounding of the scores puts the float32
plain version ~1.6e-5 from its float64 result (``chip_smoke.py`` phase 6
prints it), so two float32 computations can differ by more than the
tolerance whichever of them is the kernel.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from flash_tf32 import f32_rz, mma, tf32_rna  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-5        # the forward kernels' tolerance (tests/test_torch_cuda.py)
BK = 32           # the kernel's key tile: its online normalisation steps
MMA_K = 8         # the products one m16n8k8 MMA sums


def emulated_fwd_lse(q, k, v, *, causal, window, passes=3, chains="tile"):
    """The forward kernel's maths in the kernel layout (q (B, H, Sq, d),
    k/v (B, G, Sk, d)): (o, lse). ``chains="tile"`` is the kernel's
    accumulators (S per 16-wide slice of d, P·V per key tile);
    ``"one"`` a single accumulator for S and one for O."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    kt = k.repeat_interleave(H // G, dim=1).transpose(-1, -2)
    vh = v.repeat_interleave(H // G, dim=1)
    qs = q * ref.f32(d ** -0.5)
    s = torch.zeros((B, H, Sq, Sk))
    c = s
    for kp in range(0, d, 16):
        if chains == "tile":
            c = torch.zeros_like(s)
        for half in (0, 2):
            idx = [kp + 4 * t + half + e for t in range(4) for e in (0, 1)]
            c = mma(c, qs[..., idx], kt[..., idx, :], passes)
        s = s + c if chains == "tile" else c
    ok = ref.flash_visible(Sq, Sk, causal=causal, window=window)
    s = torch.where(ok, s, ref.NEG_INF)
    m = torch.full((B, H, Sq, 1), ref.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    o = torch.zeros((B, H, Sq, d))
    for k0 in range(0, Sk, BK):
        st = s[..., k0:k0 + BK]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        c = torch.zeros_like(o) if chains == "tile" else o * corr
        for j in range(0, p.shape[-1], MMA_K):
            c = mma(c, p[..., j:j + MMA_K], vh[..., k0 + j:k0 + j + MMA_K, :],
                    passes)
        o = ((o.double() * corr.double() + c.double()).float()
             if chains == "tile" else c)
    l = torch.clamp(l, min=1e-30)
    return o * (1 / l), (m + torch.log(l))[..., 0]


def _inputs(B, H, G, S, d, amp, seed):
    """q, k, v from numpy; q and k times ``amp`` (scores of std amp²)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, H, S, d), (B, G, S, d), (B, G, S, d)))
    return (torch.from_numpy(q * np.float32(amp)),
            torch.from_numpy(k * np.float32(amp)), torch.from_numpy(v))


def _worst(got, want):
    return float(((got.double() - want.double()).abs()
                  / (1 + want.double().abs())).max())


LARGE = 8 ** 0.5      # q and k scaled so that the scores have std 8
# name: B, H, G, S, d, causal, window, amp   (B·H ≤ 4, S ≤ 512)
CASES = {
    "causal_d128": (1, 2, 2, 256, 128, True, 0, 1.0),
    "window_d64": (1, 2, 2, 320, 64, True, 96, 1.0),
    "gqa_d64": (1, 4, 2, 192, 64, True, 0, 1.0),
    "bidirectional_d128": (2, 2, 1, 160, 128, False, 0, 1.0),
    "large_logits_d128": (1, 2, 1, 512, 128, True, 0, LARGE),
    "large_logits_d64": (2, 2, 2, 384, 64, True, 0, LARGE),
}


def _large_case():
    """The d 128 large-score case and its float64 plain result."""
    B, H, G, S, d, causal, window, amp = CASES["large_logits_d128"]
    q, k, v = _inputs(B, H, G, S, d, amp, seed=S + d)
    want = ref.flash_fwd_lse(q.double(), k.double(), v.double(),
                             causal=causal, window=window)
    return (q, k, v), dict(causal=causal, window=window), want


@pytest.mark.parametrize("name", list(CASES))
def test_split_tf32_forward_within_tolerance(name):
    """The kernel's three-product split on its accumulators keeps o and
    lse within 2e-5·(1 + |want|) of the plain version and of the JAX
    reference."""
    B, H, G, S, d, causal, window, amp = CASES[name]
    q, k, v = _inputs(B, H, G, S, d, amp, seed=S + d)
    o, lse = emulated_fwd_lse(q, k, v, causal=causal, window=window)
    large = amp != 1.0
    want_o, want_lse = ref.flash_fwd_lse(
        *((t.double() for t in (q, k, v)) if large else (q, k, v)),
        causal=causal, window=window)
    assert _worst(o, want_o) <= TOL, name
    assert _worst(lse, want_lse) <= TOL, name
    if large:
        return
    # the JAX oracle (float32) in the model layout (B, S, H, d)
    model = lambda t: jnp.asarray(t.transpose(1, 2).numpy())
    jax_o = np.array(jref.flash_attention(model(q), model(k), model(v),
                                          causal=causal, window=window))
    assert _worst(o, torch.from_numpy(jax_o).transpose(1, 2)) <= TOL, name


def test_single_tf32_pass_fails_large_logits():
    """One TF32 pass (operands rounded once, one product) misses the
    tolerance by far where the scores are large."""
    qkv, opts, (want_o, want_lse) = _large_case()
    o, lse = emulated_fwd_lse(*qkv, **opts, passes=1)
    assert max(_worst(o, want_o), _worst(lse, want_lse)) > 10 * TOL


def test_one_accumulator_chain_fails_large_logits():
    """The three products summed in one accumulator for S over all of d
    and one for O over all keys: each MMA's rounding toward zero adds up
    along the chain, and o leaves the tolerance where the scores are
    large, though the emulation sums each MMA exactly."""
    qkv, opts, (want_o, want_lse) = _large_case()
    o, lse = emulated_fwd_lse(*qkv, **opts, chains="one")
    assert max(_worst(o, want_o), _worst(lse, want_lse)) > TOL


def test_rna_rounds_to_nearest_ties_away():
    """The bit-pattern rounding keeps 10 mantissa bits, rounds to the
    nearest and ties away from zero, and leaves ±inf alone."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, one + ulp + ulp / 2, float("inf"),
                      -float("inf"), 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp,
                         one + 2 * ulp, float("inf"), -float("inf"), 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    big = tf32_rna(y)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - big).abs() / y.abs()).max()) <= 2.0 ** -11


def test_rz_rounds_toward_zero():
    """The MMA's rounding: float64 values between two float32 neighbours
    go to the one nearer zero, whatever their sign; float32 values stay."""
    ulp = 2.0 ** -23
    x = torch.tensor([1 + 0.9 * ulp, -(1 + 0.9 * ulp), 1 + 0.5 * ulp,
                      2 - 0.1 * ulp, 3.0, -0.0, 1e-45 / 3],
                     dtype=torch.float64)
    want = torch.tensor([1.0, -1.0, 1.0, 2 - ulp, 3.0, -0.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(f32_rz(x), want)
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(1000))
    z = f32_rz(y)
    assert bool((z.double().abs() <= y.abs()).all())
    assert bool(((y - z.double()).abs() < y.abs() * 2.0 ** -23).all())
