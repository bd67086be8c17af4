"""The port's flash attention on bfloat16 operands against the JAX
package's Pallas kernels, which take any float dtype (they load bf16
tiles, compute in float32 and write o, dq, dk, dv in the operands' dtype;
lse stays float32).

Inputs are float32 numpy arrays from a seed, rounded to bfloat16 in both
packages (round to nearest even in both). The JAX side runs its Pallas
kernels in interpret mode, as ``tests/test_torch_flash.py`` does; the port
runs on the CPU, where the wrapper computes the kernels' maths with the
plain versions of ``kernels/ref.py`` (the CUDA kernels are held against
those on the card in ``tests/test_torch_cuda.py``). Tolerances:

  * o, dq, dk, dv (bfloat16): within 1/64 of the largest magnitude of the
    JAX result, four bf16 ulps of it: both sides round a float32 result
    to bf16 once, but sum in other orders, and the JAX GQA dk, dv sum
    per-head bf16 values where the port sums in float32;
  * lse (float32 from the same bf16 operands): 2e-5, the forward's;
  * the model's loss at bf16 compute with ``use_pallas``: rtol 1e-2
    (every matmul rounds to bf16 in both packages), its gradients within
    3e-2 of each leaf's largest magnitude.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as FK  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.kernels import flash_attention as TFK  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

import families_common as FC

torch.set_num_threads(2)
BLOCK = 64
LSE_TOL = 2e-5
REL = 1 / 64          # of max|want|, bf16 outputs
LOSS_RTOL, GRAD_REL = 1e-2, 3e-2

# B, H, G, S, d, causal, window
CASES = [
    (2, 4, 2, 128, 64, True, 0),        # GQA
    (1, 2, 1, 192, 64, True, 64),       # sliding window
    (1, 4, 4, 128, 128, False, 0),      # bidirectional, the 400m head dim
]


def _inputs(B, H, G, S, d, seed):
    """q, k, v, dO in the kernel layout as bf16 torch tensors and bf16 jax
    arrays of the same bits."""
    rng = np.random.default_rng(seed)
    shapes = ((B, H, S, d), (B, G, S, d), (B, G, S, d), (B, H, S, d))
    f32 = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    tt = [torch.from_numpy(a).to(torch.bfloat16) for a in f32]
    jj = [jnp.asarray(a).astype(jnp.bfloat16) for a in f32]
    return tt, jj


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(got, want, rel, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(),
                               err_msg=what)


def _jax_opts(d, causal, window):
    return dict(causal=causal, window=window, scale=d ** -0.5, bq=BLOCK,
                bk=BLOCK, q_offset=0, interpret=True)


@pytest.mark.parametrize("B,H,G,S,d,causal,window", CASES)
def test_bf16_forward_matches_jax_kernels(B, H, G, S, d, causal, window):
    (q, k, v, _), (jq, jk, jv, _) = _inputs(B, H, G, S, d, S + d)
    want_o, want_lse = FK._fwd_lse(jq, jk, jv, **_jax_opts(d, causal,
                                                           window))
    assert want_o.dtype == jnp.bfloat16 and want_lse.dtype == jnp.float32
    o, lse = TFK.flash_fwd_lse(q, k, v, causal=causal, window=window)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close_rel(o, want_o, REL, "o")
    np.testing.assert_allclose(_np(lse), _np(want_lse), rtol=LSE_TOL,
                               atol=LSE_TOL)
    o_plain = TFK.flash_fwd(q, k, v, causal=causal, window=window)
    assert o_plain.dtype == torch.bfloat16
    _close_rel(o_plain, want_o, REL, "o without lse")


@pytest.mark.parametrize("B,H,G,S,d,causal,window", CASES)
def test_bf16_backward_matches_jax_kernels(B, H, G, S, d, causal, window):
    """From the JAX forward's residuals (o in bf16, lse in f32) and the
    same bf16 dO."""
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(B, H, G, S, d, 3 * S + d)
    opts = _jax_opts(d, causal, window)
    jo, jlse = FK._fwd_lse(jq, jk, jv, **opts)
    want = FK._bwd((jq, jk, jv, jo, jlse), jdo, **opts)
    o = torch.from_numpy(_np(jo).copy()).to(torch.bfloat16)
    lse = torch.from_numpy(_np(jlse).copy())
    got = TFK.flash_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close_rel(g, w, REL, name)


def test_bf16_checks():
    """bf16 operands pass the wrapper's check; float16 and mixed dtypes
    are refused (the kernels are built for float32 and bfloat16)."""
    (q, k, v, _), _ = _inputs(1, 2, 2, 128, 64, 0)
    TFK.flash_fwd(q, k, v)
    with pytest.raises(TypeError, match="float16"):
        TFK.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="one dtype"):
        TFK.flash_fwd(q, k.float(), v)


def test_bf16_model_loss_matches_jax(monkeypatch):
    """``Arch.loss(cfg.replace(use_pallas=True, compute_dtype="bfloat16"))``
    of the diloco_400m smoke config (head_dim 128, seq 128: the flash
    branch in both packages, JAX's in interpret mode) against JAX's: the
    loss and every gradient leaf. The port took a TypeError here before
    its kernels took bf16."""
    taken = {"jax": 0, "torch": 0}
    jax_fa, torch_fa = jops.flash_attention, tops.flash_attention

    def jax_interpret(*args, **kw):
        taken["jax"] += 1
        return jax_fa(*args, **{**kw, "mode": "interpret"})

    def torch_spy(q, *args, **kw):
        taken["torch"] += 1
        assert q.dtype == torch.bfloat16
        return torch_fa(q, *args, **kw)
    monkeypatch.setattr(jops, "flash_attention", jax_interpret)
    monkeypatch.setattr(tops, "flash_attention", torch_spy)
    ja, ta, jp, tp = FC.archs("diloco_400m", head_dim=128, use_pallas=True,
                              compute_dtype="bfloat16")
    b = FC.batch_np(ja.cfg, b=2, s=128)
    jl, jg = jax.value_and_grad(lambda p: ja.loss(p, FC.to_jax(b))[0])(jp)
    tp = tree.map(lambda t: t.detach().clone().requires_grad_(), tp)
    tl = ta.loss(tp, FC.to_torch(b))[0]
    grads = torch.autograd.grad(tl, tree.leaves(tp))
    # (each layer once, and again in the recompute of its remat)
    assert taken["torch"] >= ja.cfg.n_layers and taken["jax"] >= 1
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=LOSS_RTOL)
    want = FC.flat(jax.tree.map(np.asarray, jg))
    for (path, _), g in zip(tree.flatten_with_path(tp), grads):
        w = want[tuple(str(e[1]) for e in path)]
        _close_rel(g, w, GRAD_REL, str(path))
