"""``launch/op_cost.py`` against the JAX ``launch/jaxpr_cost.py``: the JAX
counter's own tests mirrored on meta tensors, the fused-leaf rule, and
the counts of every family's smoke loss (and its value and gradient)
held to JAX's count of the same function."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.jaxpr_cost import jaxpr_cost
from repro.models import registry as JR
from repro_torch import tree
from repro_torch.kernels import ops
from repro_torch.launch import op_cost as OC
from repro_torch.launch.op_cost import op_cost
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import registry as TR

META = "meta"


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META).requires_grad_(grad)


def test_looped_matmuls_count_every_trip():
    def fn(x):
        for _ in range(7):
            x = x @ x
        return x

    cost = op_cost(fn, meta(32, 32))
    assert cost["flops"] == 7 * 2 * 32 ** 3
    assert cost["dots"] == 7


def test_grad_counts_the_backward():
    loss = lambda w, x: torch.sum((x @ w) ** 2)
    grad = lambda w, x: torch.autograd.grad(loss(w, x), w)
    fwd = op_cost(loss, meta(16, 8, grad=True), meta(4, 16))
    bwd = op_cost(grad, meta(16, 8, grad=True), meta(4, 16))
    assert bwd["flops"] >= 2 * fwd["flops"]


def test_bytes_bracket():
    def fn(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    c = op_cost(fn, meta(64, 64), [meta(64, 64) for _ in range(12)])
    assert 0 < c["bytes_min"] <= c["bytes"]
    assert c["flops"] == 12 * 2 * 64 ** 3


def test_fused_leaf_counts_its_io_once():
    """A kernel wrapper is one op: its operands read and its results
    written once, the kernel's per-element FLOPs; the plain version's
    interior (the ``ref`` mode) shows in the upper bound only."""
    p = {"a": meta(1000, 64), "b": meta(64)}
    g, m, v = (tree.map(torch.empty_like, p) for _ in range(3))
    n = 1000 * 64 + 64
    fused = op_cost(lambda: ops.adamw_update_tree(p, g, m, v, lr=1e-3,
                                                  count=1))
    assert fused["leaves"] == {"fused_adamw": 2}
    assert fused["flops"] == 16 * n
    assert fused["bytes"] == fused["bytes_min"] == 7 * 4 * n
    plain = op_cost(lambda: ops.adamw_update_tree(p, g, m, v, lr=1e-3,
                                                  count=1, mode="ref"))
    assert plain["leaves"] == {} and plain["flops"] == 0
    assert plain["bytes"] > fused["bytes"] > plain["bytes_min"]


@pytest.mark.parametrize("wrapper", ["adamw", "flash"])
def test_stand_ins_refuse_real_tensors(wrapper):
    """A stand-in computes nothing: on CPU tensors the count raises,
    naming the kernel, and the real wrappers are back afterwards."""
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import fused_adamw as FA

    saved = (FA.fused_adamw_, FK.flash_fwd)
    p = {"a": torch.zeros(8, 4)}
    g, m, v = (tree.map(torch.zeros_like, p) for _ in range(3))
    q = torch.zeros(1, 2, 8, 16)
    run = {"adamw": lambda: ops.adamw_update_tree(p, g, m, v, lr=1e-3,
                                                  count=1),
           "flash": lambda: FK.flash_fwd(q, q, q)}[wrapper]
    name = {"adamw": "fused_adamw", "flash": "flash_fwd"}[wrapper]
    with pytest.raises(RuntimeError, match=f"stand-in for {name} got a "
                       "tensor on cpu"):
        op_cost(run)
    assert (FA.fused_adamw_, FK.flash_fwd) == saved


def test_flash_leaves_count_visible_pairs():
    B, S, H, G, d = 2, 256, 4, 2, 64
    q, k, v = meta(B, S, H, d, grad=True), meta(B, S, G, d, grad=True), \
        meta(B, S, G, d, grad=True)

    def fwd_bwd(q, k, v):
        o = ops.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o.sum(), (q, k, v))

    c = op_cost(fwd_bwd, q, k, v)
    assert c["leaves"] == {"flash_fwd_lse": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    pairs = S * (S + 1) // 2
    assert OC.visible_pairs(S, S, causal=True, window=0) == pairs
    assert OC.visible_pairs(S, S, causal=True, window=16) == \
        16 * S - 16 * 15 // 2
    assert c["flops"] == (4 + 6 + 8) * d * pairs * B * H
    # the plain attention's interior (the full S×S scores) is in its
    # upper bound only; the fused leaves move the boundary I/O
    plain = op_cost(lambda q, k, v: torch.autograd.grad(
        ops.flash_attention(q, k, v, causal=True, mode="ref").sum(),
        (q, k, v)), q, k, v)
    assert plain["bytes"] > c["bytes"]
    assert c["bytes_min"] < plain["bytes_min"]


def test_fused_ce_cheaper_than_log_softmax():
    B, S, V = 4, 32, 1000
    lg, tk = meta(B, S, V), torch.empty((B, S), dtype=torch.int64,
                                        device=META)

    def log_softmax_version(lg, tk):
        lp = torch.log_softmax(lg[:, :-1].float(), -1)
        return -torch.gather(lp, -1, tk[:, 1:, None])[..., 0].mean()

    fused = op_cost(TL.next_token_loss, lg, tk)
    old = op_cost(log_softmax_version, lg, tk)
    assert fused["bytes"] < old["bytes"]
    lg_, tk_ = torch.randn(B, S, V), torch.randint(0, V, (B, S))
    torch.testing.assert_close(TL.next_token_loss(lg_, tk_),
                               log_softmax_version(lg_, tk_), rtol=1e-5,
                               atol=0)


def test_whisper_decode_flops_near_model_flops():
    """Decode FLOPs stay within ~4x of 2·N·B (the cross K/V is cached at
    prefill, not recomputed per step)."""
    arch = TR.get_smoke_arch("whisper_large_v3")
    cfg = arch.cfg
    params = arch.init(generator=None, device=META)
    n = sum(t.numel() for t in tree.leaves(params))
    B, S = 2, 16
    cache = TM.init_cache(cfg, B, S, torch.float32, device=META)
    tok = torch.empty((B, 1), dtype=torch.int64, device=META)
    cost = op_cost(lambda p, c, t: TM.decode_step(p, cfg, c, t, S - 1),
                   params, cache, tok)
    assert 0 < cost["flops"] < 6 * 2 * n * B


# ---------------------------------------------------------------------------
# every family's smoke loss against JAX's count
# ---------------------------------------------------------------------------

B, S = 2, 32
DENSE = [n for n in JR.ARCH_NAMES
         if JR.get_smoke_arch(n).cfg.family == "dense"]


def _counts(name, remat: bool):
    """(JAX forward, JAX value_and_grad, port forward, port loss + grad)
    counts of the smoke config's loss at B × S."""
    ja, ta = JR.get_smoke_arch(name), TR.get_smoke_arch(name)
    jc, tc = ja.cfg.replace(remat=remat), ta.cfg.replace(remat=remat)
    js, _ = JR.Arch(jc).abstract_params()
    jb = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tb = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    extra = {"vlm": ("patches", jc.n_patches),
             "encdec": ("frames", jc.n_frames)}.get(jc.family)
    if extra:
        jb[extra[0]] = jax.ShapeDtypeStruct((B, extra[1], jc.d_model),
                                            jnp.float32)
        tb[extra[0]] = meta(B, extra[1], jc.d_model)
    jloss = lambda p, b: ja.loss(p, b, cfg=jc)[0]
    tp = ta.abstract_params(tc)[0]

    def tgrad(p, b):
        req = tree.map(lambda t: t.requires_grad_(True), p)
        return torch.autograd.grad(ta.loss(req, b, cfg=tc)[0],
                                   tree.leaves(req), allow_unused=True)

    return (jaxpr_cost(jloss, js, jb),
            jaxpr_cost(jax.value_and_grad(jloss), js, jb),
            op_cost(lambda p, b: ta.loss(p, b, cfg=tc)[0], tp, tb),
            op_cost(tgrad, tp, tb))


@pytest.mark.parametrize("name", DENSE)
def test_dense_counts_equal_jax(name):
    """Exactly JAX's counts with remat off, within 0.5 % with it on. The
    one exception is command-R's parallel block under remat: the port's
    checkpoint recomputes the whole layer, where JAX's recompute leaves
    out the attention's output projection (``wo``), whose output no
    backward reads (one more dot a layer here)."""
    jf, jg, tf, tg = _counts(name, remat=False)
    assert (tf["flops"], tf["dots"]) == (jf["flops"], jf["dots"])
    assert (tg["flops"], tg["dots"]) == (jg["flops"], jg["dots"])
    jf, jg, tf, tg = _counts(name, remat=True)
    assert tf["flops"] == jf["flops"]
    cfg = TR.get_smoke_arch(name).cfg
    if cfg.parallel_block:
        assert tg["dots"] - jg["dots"] == cfg.n_layers
        assert tg["flops"] - jg["flops"] == cfg.n_layers * 2 * B * S \
            * cfg.n_heads * cfg.resolved_head_dim * cfg.d_model
    else:
        assert abs(tg["flops"] / jg["flops"] - 1) <= 5e-3


@pytest.mark.parametrize("name", [n for n in JR.ARCH_NAMES
                                  if n not in DENSE])
def test_family_forward_flops_against_jax(name):
    """Forward FLOPs and dots equal JAX's, except zamba2's: the SSD scan's
    three-operand einsums (``models/ssm.ssd_chunked``: ydiag, the chunk
    states, yoff) are one contraction each in the port, which scales one
    operand elementwise first, and two ``dot_general``s each in JAX (its
    pairwise einsum makes the elementwise product a batch-only dot): 3
    more dots a mamba2 layer there, and their FLOPs, within 1 %."""
    jf, jg, tf, tg = _counts(name, remat=False)
    if name == "zamba2_2_7b":
        cfg = TR.get_smoke_arch(name).cfg
        layers = TM.make_plan(cfg).pattern.count("mamba2") \
            * TM.make_plan(cfg).n_groups
        assert jf["dots"] - tf["dots"] == 3 * layers
        assert abs(tf["flops"] / jf["flops"] - 1) <= 1e-2
    else:
        assert (tf["flops"], tf["dots"]) == (jf["flops"], jf["dots"])
    assert abs(tg["flops"] / jg["flops"] - 1) <= 3e-2


def test_live_storage_is_tracked():
    """The counter tracks what a run allocates and frees on meta tensors:
    a chain's peak is its two largest live tensors, its end what it
    returns."""
    def fn(x):
        y = x * 2                 # 400 B
        z = y + 1                 # 400 B; y freed after
        del y
        return z.sum()            # 4 B

    c = op_cost(fn, meta(10, 10))
    assert c["peak_live_bytes"] == 800
    assert c["end_live_bytes"] == 4
    assert c["bytes"] == 400 + 400 + 4
