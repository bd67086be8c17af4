"""The arithmetic of the bf16 flash-attention kernels (forward, dq and
dk/dv) on the CPU.

On bf16 operands ``csrc/flash_attention.cu`` runs its forward
(``flash_fwd_bf16_kernel``), dq (``flash_dq_bf16_kernel``) and dk/dv
(``flash_dkv_bf16_kernel``) on the bf16 tensor cores (``wgmma`` m64nNk16,
f32 accumulators). The kernels run only on the card; this file emulates
their products as they issue them:

- a product of two bf16 tensors is exact (8-bit significands), so q·kᵀ
  (forward, dq), dO·vᵀ (dq), k·qᵀ and v·dOᵀ (dk/dv) take one MMA per
  16-wide slice of d, chained in one accumulator over all of d; the scale
  multiplies the f32 result (the Pallas kernels scale q in f32 first: one
  f32 rounding a score apart);
- a product with an f32 operand that the kernel computes (p·v, dS·k,
  pᵀ·dO, dSᵀ·q) splits it into hi = bf16(x) and lo = bf16(x − hi), which
  hold x to ~2⁻¹⁷ of itself, and issues two MMAs, lo then hi, into the f32
  accumulator;
- each MMA sums its 16 products (exact) and its accumulator and rounds the
  sum toward zero to f32, as the tensor cores do (``flash_tf32.f32_rz``;
  the emulation sums exactly before that one rounding, so it is kinder
  than the card);
- the chains are long: the score products one chain over all of d; the
  forward's o is multiplied by the softmax correction before each 64-key
  tile and p·v accumulates into it, one chain over all keys; dq's dS·k one
  chain over all keys, times the scale at the end; dk/dv's pᵀ·dO and dSᵀ·q
  one chain over all the group's query heads and their query tiles. The
  f32 kernels sum each 16-wide slice of d and each tile from zero,
  because the round-toward-zero drift of long chains reaches their 2e-5;
  here it stays within that of float64 (``chains="tile"``, the f32
  kernels' shape, lands as close), while the bf16 outputs' rounding is
  2⁻⁹ of them;
- around them the plain versions' maths: ``ref.flash_fwd_lse``'s masks and
  the kernel's online normalisation over 64-key tiles, p = exp(s − lse).

Held as ``tests/test_torch_cuda.py`` holds the kernels on the card: o, dq,
dk and dv rounded to bf16 against the plain versions' bf16 results at rtol
2⁻⁷ with atol 2e-5 (o) or 5e-4 (dq, dk, dv), lse at 2e-5. With scores of
std 8 the plain versions run on float64 copies of the inputs, as
``test_torch_flash_tf32.py`` explains. A single bf16 pass for p (or for
dS, pᵀ and dSᵀ), which rounds p to bf16 as PyTorch's bf16 attention does,
must fall outside that check: where o, dq, dk or dv sums near-cancelling
terms its 2⁻⁹ error a term exceeds the absolute tolerance.

``python tests/test_torch_flash_bf16_mma.py`` (with ``PYTHONPATH=src``)
prints each case's worst error over its bound, for the kernels' design
and for one bf16 pass.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flash_tf32 import f32_rz  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)
FWD_TOL, BWD_TOL, LSE_TOL = 2e-5, 5e-4, 2e-5   # tests/test_torch_cuda.py
RTOL = 2 ** -7                                  # two bf16 ulps
BK = 64           # the forward's key tile: its online normalisation steps
BQ = 64           # dk/dv's query tile
BKQ = 64          # dq's key tile
MMA_K = 16        # the products one bf16 MMA sums
bf16 = torch.bfloat16


def split(x, passes=2):
    """The f32 operand x as the MMAs read it: [lo, hi] with hi = bf16(x)
    and lo = bf16(x − hi) (``passes=2``), or [bf16(x)] (``passes=1``)."""
    hi = x.to(bf16).float()
    return [hi] if passes == 1 else [(x - hi).to(bf16).float(), hi]


def mma_chain(c, a, b, passes=None, fresh=False):
    """c + a @ b over the shared dimension in 16-wide slices, one MMA (or
    one per part of the split a: lo, then hi) a slice, each summed exactly
    and rounded toward zero to f32. a (.., m, n) is bf16 (passes=None) or
    f32 to be split; b (.., n, p) bf16. ``fresh``: c starts from zero."""
    n = a.shape[-1]
    c = torch.zeros(a.shape[:-1] + b.shape[-1:]) if fresh else c
    a = a.float() if passes is None else a
    b = b.double()
    for j in range(0, n, MMA_K):
        parts = ([a[..., j:j + MMA_K]] if passes is None
                 else split(a[..., j:j + MMA_K], passes))
        for x in parts:
            c = f32_rz(c.double() + x.double() @ b[..., j:j + MMA_K, :])
    return c


def emulated_fwd_lse(q, k, v, *, causal, window, passes=2, chains="one"):
    """The bf16 forward kernel's maths in the kernel layout (bf16 q (B, H,
    Sq, d), k/v (B, G, Sk, d)): (o in f32, before its rounding to bf16,
    lse). ``chains="tile"``: each key tile's p·v from zero, folded into o
    with the correction in one fused multiply-add."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    kt = k.repeat_interleave(H // G, dim=1).transpose(-1, -2)
    vh = v.repeat_interleave(H // G, dim=1)
    s = mma_chain(None, q, kt, fresh=True) * ref.f32(d ** -0.5)
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
        if chains == "one":
            o = mma_chain(o * corr, p, vh[..., k0:k0 + BK, :], passes)
        else:
            c = mma_chain(None, p, vh[..., k0:k0 + BK, :], passes,
                          fresh=True)
            o = (o.double() * corr.double() + c.double()).float()
    l = torch.clamp(l, min=1e-30)
    return o * (1 / l), (m + torch.log(l))[..., 0]


def emulated_dq(q, k, v, lse, do, delta, *, causal, window, passes=2,
                chains="one"):
    """The bf16 dq kernel's maths in the kernel layout: dq in f32, before
    its rounding to bf16. S = q·kᵀ and dP = dO·vᵀ exact bf16 chains over d,
    p = exp(S·scale − lse) where visible, dS = p∘(dP − Δ) split hi/lo, dS·k
    one chain over all keys (``chains="tile"``: each 64-key tile from zero,
    added in f32), times the scale."""
    d, Sk = q.shape[-1], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    scale = ref.f32(d ** -0.5)
    kh, vh = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    ok = ref.flash_visible(q.shape[2], Sk, causal=causal, window=window)
    s = mma_chain(None, q, kh.transpose(-1, -2), fresh=True) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = mma_chain(None, do, vh.transpose(-1, -2), fresh=True)
    ds = p * (dp - delta[..., None])
    acc = torch.zeros(q.shape)
    for k0 in range(0, Sk, BKQ):
        x, y = ds[..., k0:k0 + BKQ], kh[..., k0:k0 + BKQ, :]
        if x.shape[-1] % MMA_K:                # the tile's zero-filled rows
            pad = MMA_K - x.shape[-1] % MMA_K
            x = torch.nn.functional.pad(x, (0, pad))
            y = torch.nn.functional.pad(y.float(), (0, 0, 0, pad))
        if chains == "one":
            acc = mma_chain(acc, x, y, passes)
        else:
            acc = acc + mma_chain(None, x, y, passes, fresh=True)
    return acc * scale


def emulated_dkv(q, k, v, lse, do, delta, *, causal, window, passes=2,
                 chains="one"):
    """The bf16 dk/dv kernel's maths in the kernel layout: (dk, dv) in
    f32, before their rounding to bf16, summed over each GQA group.
    ``chains="tile"``: each query tile's products from zero, added in
    f32."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    rep = H // G
    scale = ref.f32(d ** -0.5)
    kh, vh = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    ok = ref.flash_visible(Sq, Sk, causal=causal, window=window).T
    st = mma_chain(None, kh, q.transpose(-1, -2), fresh=True) * scale
    pt = torch.where(ok, torch.exp(st - lse[..., None, :]), 0.0)
    dpt = mma_chain(None, vh, do.transpose(-1, -2), fresh=True)
    dst = pt * (dpt - delta[..., None, :])
    dk = torch.zeros((B, G, Sk, d))
    dv = torch.zeros((B, G, Sk, d))
    for r in range(rep):
        heads = slice(r, H, rep)
        for q0 in range(0, Sq, BQ):
            cols = slice(q0, q0 + BQ)
            args = [(pt, do, dv), (dst, q, dk)]
            for i, (x, y, acc) in enumerate(args):
                x, y = x[:, heads, :, cols], y[:, heads, cols]
                if x.shape[-1] % MMA_K:        # the tile's zero-filled rows
                    pad = MMA_K - x.shape[-1] % MMA_K
                    x = torch.nn.functional.pad(x, (0, pad))
                    y = torch.nn.functional.pad(y.float(), (0, 0, 0, pad))
                if chains == "one":
                    acc = mma_chain(acc, x, y, passes)
                else:
                    acc = acc + mma_chain(None, x, y, passes, fresh=True)
                if i:
                    dk = acc
                else:
                    dv = acc
    return dk * scale, dv


def _inputs(B, H, G, Sq, Sk, d, amp, seed):
    """bf16 q, k, v, dO from numpy; q and k times ``amp`` (scores of std
    amp²)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for shape
                   in ((B, H, Sq, d), (B, G, Sk, d), (B, G, Sk, d),
                       (B, H, Sq, d)))
    return tuple(torch.from_numpy(t).to(bf16) for t in
                 (q * np.float32(amp), k * np.float32(amp), v, do))


def _outside(got, want, atol, rtol=RTOL):
    """How far ``got`` lies outside |got − want| ≤ atol + rtol·|want| at
    its worst (> 0: outside)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() - atol - rtol * w.abs()).max())


LARGE = 8 ** 0.5      # q and k scaled so that the scores have std 8
# name: B, H, G, (Sq, Sk), d, causal, window, amp   (B·H ≤ 4)
CASES = {
    "causal_d128": (1, 2, 2, (256, 256), 128, True, 0, 1.0),
    "window_d64": (1, 2, 2, (320, 320), 64, True, 96, 1.0),
    "gqa_d64": (1, 4, 2, (192, 192), 64, True, 0, 1.0),
    "bidirectional_d128": (2, 2, 1, (160, 160), 128, False, 0, 1.0),
    "ragged_d64": (1, 2, 1, (100, 229), 64, True, 0, 1.0),
    "large_logits_d128": (1, 2, 1, (384, 384), 128, True, 0, LARGE),
    "large_logits_d64": (1, 2, 2, (320, 320), 64, True, 0, LARGE),
}


def _case(name):
    B, H, G, (Sq, Sk), d, causal, window, amp = CASES[name]
    qkvdo = _inputs(B, H, G, Sq, Sk, d, amp, seed=Sq + Sk + d)
    return qkvdo, dict(causal=causal, window=window), amp != 1.0


def _plain_fwd(q, k, v, opts, large):
    """The plain forward (o as bf16, lse): on float64 copies where the
    scores are large."""
    if not large:
        return ref.flash_fwd_lse(q, k, v, **opts)
    o, lse = ref.flash_fwd_lse(q.double(), k.double(), v.double(), **opts)
    return o.to(bf16), lse


def _plain_dkv(q, k, v, lse, do, delta, opts, large):
    """The plain dk/dv (bf16) on the kernel's residuals: on float64 copies
    of everything where the scores are large."""
    if large:
        q, k, v, lse, do, delta = (t.double() for t in
                                   (q, k, v, lse, do, delta))
    dk, dv = ref.flash_bwd_dkv(q, k, v, lse, do, delta, **opts)
    return dk.to(bf16), dv.to(bf16)


def _plain_dq(q, k, v, lse, do, delta, opts, large):
    """The plain dq (bf16) on the kernel's residuals: on float64 copies of
    everything where the scores are large."""
    if large:
        q, k, v, lse, do, delta = (t.double() for t in
                                   (q, k, v, lse, do, delta))
    return ref.flash_bwd_dq(q, k, v, lse, do, delta, **opts).to(bf16)


def _residuals(q, k, v, do, opts):
    """lse and Δ = rowsum(dO∘O) (f32) from the plain forward, as the
    backward kernels receive them."""
    o, lse = ref.flash_fwd_lse(q, k, v, **opts)
    return lse, (do.float() * o.float()).sum(-1)


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_forward_within_tolerance(name):
    """The forward's bf16 MMAs (exact q·kᵀ, split p) keep o within the
    card test's bound of the plain version and lse within 2e-5."""
    (q, k, v, _), opts, large = _case(name)
    o, lse = emulated_fwd_lse(q, k, v, **opts)
    want_o, want_lse = _plain_fwd(q, k, v, opts, large)
    assert _outside(o.to(bf16), want_o, FWD_TOL) <= 0, name
    assert _outside(lse, want_lse, LSE_TOL, LSE_TOL) <= 0, name


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_dkv_within_tolerance(name):
    """dk/dv's bf16 MMAs (exact kᵀ·q and vᵀ·dO, split pᵀ and dSᵀ, one
    chain over the group's queries) keep dk and dv within the card test's
    bound of the plain versions."""
    (q, k, v, do), opts, large = _case(name)
    lse, delta = _residuals(q, k, v, do, opts)
    got = emulated_dkv(q, k, v, lse, do, delta, **opts)
    want = _plain_dkv(q, k, v, lse, do, delta, opts, large)
    for g, w, what in zip(got, want, ("dk", "dv")):
        assert _outside(g.to(bf16), w, BWD_TOL) <= 0, (name, what)


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_dq_within_tolerance(name):
    """dq's bf16 MMAs (exact q·kᵀ and dO·vᵀ, split dS, one chain over all
    keys) keep dq within the card test's bound of the plain version."""
    (q, k, v, do), opts, large = _case(name)
    lse, delta = _residuals(q, k, v, do, opts)
    got = emulated_dq(q, k, v, lse, do, delta, **opts)
    want = _plain_dq(q, k, v, lse, do, delta, opts, large)
    assert _outside(got.to(bf16), want, BWD_TOL) <= 0, name


@pytest.mark.parametrize("name", ["causal_d128", "large_logits_d128"])
def test_one_bf16_pass_for_p_fails(name):
    """p rounded to bf16 once (one MMA a slice) puts o outside the
    forward's bound, at scores of std 1 and 8."""
    (q, k, v, _), opts, large = _case(name)
    o, _ = emulated_fwd_lse(q, k, v, **opts, passes=1)
    want = _plain_fwd(q, k, v, opts, large)[0]
    assert _outside(o.to(bf16), want, FWD_TOL) > 0


@pytest.mark.parametrize("name", ["causal_d128", "large_logits_d128"])
def test_one_bf16_pass_for_pt_dst_fails(name):
    """pᵀ and dSᵀ rounded to bf16 once put dk or dv outside the
    backward's bound, at scores of std 1 and 8."""
    (q, k, v, do), opts, large = _case(name)
    lse, delta = _residuals(q, k, v, do, opts)
    got = emulated_dkv(q, k, v, lse, do, delta, **opts, passes=1)
    want = _plain_dkv(q, k, v, lse, do, delta, opts, large)
    assert max(_outside(g.to(bf16), w, BWD_TOL)
               for g, w in zip(got, want)) > 0


@pytest.mark.parametrize("name", ["causal_d128", "large_logits_d128"])
def test_one_bf16_pass_for_ds_fails(name):
    """dS rounded to bf16 once puts dq outside the backward's bound, at
    scores of std 1 and 8."""
    (q, k, v, do), opts, large = _case(name)
    lse, delta = _residuals(q, k, v, do, opts)
    got = emulated_dq(q, k, v, lse, do, delta, **opts, passes=1)
    want = _plain_dq(q, k, v, lse, do, delta, opts, large)
    assert _outside(got.to(bf16), want, BWD_TOL) > 0


@pytest.mark.parametrize("chains", ["one", "tile"])
def test_long_chains_keep_f32_accuracy(chains):
    """Before their rounding to bf16, the kernels' f32 o and lse stay
    within the f32 forward's 2e-5·(1 + |want|) of float64, and dk and dv
    within the f32 backward's 5e-4·(1 + |want|), where the scores are
    large (std 8), whether the chains are long (the bf16 kernels') or
    start from zero each tile (the f32 kernels'): the chains' drift is far
    below the bf16 outputs' rounding. dq likewise, within 5e-4·(1 +
    |want|)."""
    (q, k, v, do), opts, _ = _case("large_logits_d128")
    o, lse = emulated_fwd_lse(q, k, v, **opts, chains=chains)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    want_o, want_lse = ref.flash_fwd_lse(q64, k64, v64, **opts)
    assert _outside(o, want_o, FWD_TOL, FWD_TOL) <= 0
    assert _outside(lse, want_lse, FWD_TOL, FWD_TOL) <= 0
    lse, delta = _residuals(q, k, v, do, opts)
    got = emulated_dkv(q, k, v, lse, do, delta, **opts, chains=chains)
    want = ref.flash_bwd_dkv(q64, k64, v64, lse.double(), do64,
                             delta.double(), **opts)
    for g, w in zip(got, want):
        assert _outside(g, w, BWD_TOL, BWD_TOL) <= 0
    dq = emulated_dq(q, k, v, lse, do, delta, **opts, chains=chains)
    want_dq = ref.flash_bwd_dq(q64, k64, v64, lse.double(), do64,
                               delta.double(), **opts)
    assert _outside(dq, want_dq, BWD_TOL, BWD_TOL) <= 0


def test_split_holds_x_to_2_pow_minus_17():
    """hi + lo holds an f32 value to within 2⁻¹⁷ of itself; hi alone only
    to 2⁻⁹."""
    x = torch.from_numpy(np.random.default_rng(2).random(
        4096).astype(np.float32))
    lo, hi = split(x)
    assert float(((hi + lo - x).abs() / x).max()) <= 2.0 ** -17
    assert float(((hi - x).abs() / x).max()) > 2.0 ** -10


def _ratio(got, want, atol, rtol=RTOL):
    """The worst |got − want| / (atol + rtol·|want|) (> 1: outside)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


if __name__ == "__main__":
    for name in CASES:
        (q, k, v, do), opts, large = _case(name)
        want_o, want_lse = _plain_fwd(q, k, v, opts, large)
        lse, delta = _residuals(q, k, v, do, opts)
        want = _plain_dkv(q, k, v, lse, do, delta, opts, large)
        want_dq = _plain_dq(q, k, v, lse, do, delta, opts, large)
        row = {}
        for passes in (2, 1):
            o, got_lse = emulated_fwd_lse(q, k, v, **opts, passes=passes)
            dk, dv = emulated_dkv(q, k, v, lse, do, delta, **opts,
                                  passes=passes)
            dq = emulated_dq(q, k, v, lse, do, delta, **opts, passes=passes)
            row[passes] = dict(
                o=_ratio(o.to(bf16), want_o, FWD_TOL),
                dq=_ratio(dq.to(bf16), want_dq, BWD_TOL),
                lse=_ratio(got_lse, want_lse, LSE_TOL, LSE_TOL),
                dk=_ratio(dk.to(bf16), want[0], BWD_TOL),
                dv=_ratio(dv.to(bf16), want[1], BWD_TOL))
        print(name, "split:", {k_: round(x, 3) for k_, x in row[2].items()},
              "one pass:", {k_: round(x, 3) for k_, x in row[1].items()
                            if k_ != "lse"})
