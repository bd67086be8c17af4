"""Products accumulated in float32 at bf16 compute, and the correctly
rounded square root of the plain maths.

JAX computes the MoE router, the attention scores and ``p·v``, the LM head
and the SSD scores with ``preferred_element_type=jnp.float32``: bf16
operands, float32 sums, a float32 result. The port's counterparts
(``layers.f32_product`` and ``layers.f32_matmul``) widen bf16 operands
before the product, so only the order of the float32 sums differs from
JAX's. Held here: ``apply_moe`` of the olmoe and deepseek smoke configs at
bf16 compute (``groups`` 2) and ``lm_logits`` against JAX's, the aux loss,
the router's probabilities and the logits within 1e-6 of the largest (a
product rounded to bf16 before it is widened lands 1.6e-5 apart on the
aux loss); and on float32 operands each repaired site's product bitwise
the plain einsum it was before.

``ref.sqrt_rn`` is the root of the AdamW and outer-Adam plain versions and
of the clip's norm: correctly rounded, as XLA's and CUDA's roots are,
where the CPU's float32 ``torch.sqrt`` is one ulp off on some inputs.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import moe as JMOE
from repro_torch.kernels.ref import sqrt_rn
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE

import families_common as FC

REL = 1e-6            # float32 summation error, of the largest entry


def _moe(name):
    """(JAX cfg, port cfg, JAX MoE params, port MoE params) of layer 0 of
    the smoke config at bf16 compute."""
    ja, ta, jp, tp = FC.archs(name)
    jm = jax.tree.map(lambda a: a[0], jp["stack0"]["moe"])
    tm = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in tp["stack0"]["moe"].items()}
    return (ja.cfg.replace(compute_dtype="bfloat16"),
            ta.cfg.replace(compute_dtype="bfloat16"), jm, tm)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["olmoe_1b_7b", "deepseek_v2_lite_16b"])
def test_bf16_moe_router_matches_jax(monkeypatch, name):
    """At bf16 compute, groups 2: the aux loss and the router's
    probabilities (as top-k reads them) within 1e-6 of the largest, the
    top-k choices equal, the bf16 output within a few bf16 steps."""
    jcfg, tcfg, jm, tm = _moe(name)
    x = np.random.default_rng(0).standard_normal(
        (4, 16, jcfg.d_model)).astype(np.float32)
    seen = {}

    def spy(pkg, fn):
        def wrapped(probs, K):
            out = fn(probs, K)
            seen[pkg] = [np.asarray(t.detach().float().numpy()
                                    if torch.is_tensor(t) else t)
                         for t in (probs, out[1])]
            return out
        return wrapped
    monkeypatch.setattr(JMOE, "_topk_iterative",
                        spy("jax", JMOE._topk_iterative))
    monkeypatch.setattr(TMOE, "_topk_iterative",
                        spy("torch", TMOE._topk_iterative))
    jy, jaux = JMOE.apply_moe(jm, jnp.asarray(x).astype(jnp.bfloat16), jcfg,
                              groups=2)
    ty, taux = TMOE.apply_moe(tm, torch.from_numpy(x).to(torch.bfloat16),
                              tcfg, groups=2)
    assert abs(float(taux) - float(jaux)) <= REL * abs(float(jaux)), \
        (float(taux), float(jaux))
    assert _rel(seen["torch"][0], seen["jax"][0]) <= REL
    np.testing.assert_array_equal(seen["torch"][1], seen["jax"][1])
    assert ty.dtype == torch.bfloat16
    assert _rel(ty.float().numpy(), np.asarray(jy.astype(jnp.float32))) \
        <= 2.0 ** -5


@pytest.mark.parametrize("tied", [False, True])
def test_bf16_lm_logits_match_jax(tied):
    """The LM head at bf16 compute: float32 logits within 1e-6 of the
    largest of JAX's (tied: the embedding table's transpose)."""
    jcfg, tcfg, _, _ = _moe("olmoe_1b_7b")
    jcfg, tcfg = (c.replace(tie_embeddings=tied) for c in (jcfg, tcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    w = (0.05 * rng.standard_normal((jcfg.d_model, jcfg.vocab_size))
         ).astype(np.float32)
    head, emb = ({}, {"table": w.T.copy()}) if tied else ({"w": w}, {})
    jl = JL.lm_logits(jax.tree.map(jnp.asarray, head),
                      jax.tree.map(jnp.asarray, emb),
                      jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    tl = TL.lm_logits({k: torch.from_numpy(v) for k, v in head.items()},
                      {k: torch.from_numpy(v) for k, v in emb.items()},
                      torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert tl.dtype == torch.float32
    assert _rel(tl.numpy(), np.asarray(jl)) <= REL


# each repaired site's product: (equation, operand shapes)
SITES = {
    "router": ("gtd,de->gte", (2, 8, 16), (16, 4)),
    "scores": ("bqgrd,bkgd->bgrqk", (2, 8, 2, 2, 16), (2, 12, 2, 16)),
    "p_v": ("bgrqk,bkgd->bqgrd", (2, 2, 2, 8, 12), (2, 12, 2, 16)),
    "p_v_chunk": ("bgrqk,bkgd->bgrqd", (2, 2, 2, 8, 12), (2, 12, 2, 16)),
    "ssd_scores": ("bcin,bcjn->bcij", (2, 3, 4, 8), (2, 3, 4, 8)),
}


@pytest.mark.parametrize("site", sorted(SITES) + ["lm_logits"])
def test_f32_operands_run_the_plain_product(site):
    """On float32 operands a repaired site computes its plain product,
    bit for bit; on bf16 operands, the product of their float32 values."""
    rng = np.random.default_rng(2)
    if site == "lm_logits":
        shapes = ((2, 8, 16), (16, 32))
    else:
        eq, *shapes = SITES[site]
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes)
    if site == "lm_logits":
        got, want = TL.f32_matmul(a, b), a @ b
        widened = TL.f32_matmul(a.bfloat16(), b.bfloat16())
        want_w = a.bfloat16().float() @ b.bfloat16().float()
    else:
        got, want = TL.f32_product(eq, a, b), torch.einsum(eq, a, b)
        widened = TL.f32_product(eq, a.bfloat16(), b.bfloat16())
        want_w = torch.einsum(eq, a.bfloat16().float(), b.bfloat16().float())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert widened.dtype == torch.float32 and torch.equal(widened, want_w)


def test_sqrt_rn_is_correctly_rounded():
    """``sqrt_rn`` against the float64 root rounded once, on a million
    uniform float32 inputs and on the inputs where the CPU's float32
    ``torch.sqrt`` is not correctly rounded (bit for bit on both); bf16
    and card operands keep ``torch.sqrt``."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.random(1_000_000, dtype=np.float32),
        (rng.random(10_000) * 1e-12).astype(np.float32),
        (rng.random(10_000) * 1e6).astype(np.float32)]))
    want = torch.from_numpy(np.sqrt(x.numpy().astype(np.float64))
                            .astype(np.float32))
    got = sqrt_rn(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    off = ~torch.eq(torch.sqrt(x), want)
    if off.any():        # the inputs where the plain float32 root is off
        assert torch.equal(sqrt_rn(x[off]), want[off])
    h = x[:100].bfloat16()
    assert torch.equal(sqrt_rn(h), torch.sqrt(h))


@pytest.mark.parametrize("eq", sorted(TL._AS_GEMM))
def test_gemm_layouts_equal_the_einsum(monkeypatch, eq):
    """The card's route (``torch.bmm``/``torch.mm`` with ``out_dtype``,
    which the CPU build lacks) lays each equation's operands out as GEMM
    batches and its result back: with a float32 GEMM in its place, bit
    for bit the einsum of the operands' float32 values."""
    monkeypatch.setattr(TL, "_gemm_f32_ok", lambda a, b: True)
    monkeypatch.setattr(TL, "_gemm_f32", lambda a, b: a.float() @ b.float())
    shapes = {"bqgrd,bkgd->bgrqk": ((2, 5, 3, 2, 8), (2, 7, 3, 8)),
              "bgrqk,bkgd->bgrqd": ((2, 3, 2, 5, 7), (2, 7, 3, 8)),
              "bgrqk,bkgd->bqgrd": ((2, 3, 2, 5, 7), (2, 7, 3, 8)),
              "bcin,bcjn->bcij": ((2, 3, 4, 6), (2, 3, 4, 6)),
              "gtd,de->gte": ((2, 5, 8), (8, 4)),
              "bshd,bcd->bhsc": ((2, 3, 4, 8), (2, 7, 8)),
              "bhsc,bcr->bshr": ((2, 4, 3, 7), (2, 7, 8))}[eq]
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in shapes)
    got = TL.f32_product(eq, a, b)
    want = torch.einsum(eq, a.float(), b.float())
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
