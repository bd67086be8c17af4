"""The port's dense model against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
model runs from parameters made by the JAX init (``convert``).
Tolerances:

  * rope, norm: rtol 1e-5, atol 1e-6 (elementwise; cos/sin/rsqrt may
    differ by an ulp between XLA and PyTorch);
  * attention: rtol 1e-5, atol 1e-5 (softmax and the chunked online
    softmax sum in another order);
  * logits and loss: rtol 1e-5, atol 1e-5 (matmul reduction order);
  * gradients (``jax.grad`` against ``torch.autograd``): rtol 1e-4,
    atol 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
ARCHS = ["diloco_60m", "diloco_150m"]


def _close(got, want, rtol, atol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _randn(rng, *shape):
    return np.asarray(rng.standard_normal(shape), np.float32)


@pytest.mark.parametrize("pct", [1.0, 0.5, 0.25])
@pytest.mark.parametrize("batched_pos", [False, True])
def test_apply_rope(pct, batched_pos):
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, 16, 4, 32)
    pos = np.arange(16, dtype=np.int32) + 3
    if batched_pos:
        pos = np.stack([pos, pos + 100])
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, pct)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        10_000.0, pct)
    _close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 8, 64)
    params = {"scale": _randn(rng, 64)}
    if kind == "layernorm":
        params["bias"] = _randn(rng, 64)
    want = JL.apply_norm(tree.map(jnp.asarray, params), jnp.asarray(x), kind)
    got = TL.apply_norm(tree.map(torch.from_numpy, params),
                        torch.from_numpy(x), kind)
    _close(got, want, 1e-5, 1e-6)


# direct path (Sk <= 2048) and the chunked online-softmax path
# (Sk = 2304 > max(2 * chunk, 2048)), GQA (4 heads over 2 kv heads)
@pytest.mark.parametrize("S,chunk", [(64, 1024), (2304, 256)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
def test_attention(S, chunk, causal, window):
    rng = np.random.default_rng(S + window)
    q = _randn(rng, 1, S, 4, 16)
    k = _randn(rng, 1, S, 2, 16)
    v = _randn(rng, 1, S, 2, 16)
    want = JL.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                        window=window, chunk=chunk)
    got = TL.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                       window=window, chunk=chunk)
    _close(got, want, 1e-5, 1e-5)


def _models(name):
    jarch = jreg.get_smoke_arch(name)
    jparams, _ = jarch.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tarch = treg.get_smoke_arch(name)
    tparams = convert.params_from_numpy(np_params, device="cpu")
    return jarch, jparams, tarch, tparams


def _tokens(vocab, B=2, S=32, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_param_tree_matches_jax(name):
    jarch, jparams, tarch, _ = _models(name)
    gen = torch.Generator().manual_seed(0)
    own = tarch.init(generator=gen, device="cpu")
    want = {p: np.asarray(a).shape for p, a in
            tree.paths(jax.tree.map(np.asarray, jparams))}
    assert {p: tuple(t.shape) for p, t in tree.paths(own)} == want


@pytest.mark.parametrize("name", ARCHS)
def test_logits_and_loss(name):
    jarch, jparams, tarch, tparams = _models(name)
    toks = _tokens(jarch.cfg.vocab_size)
    from repro.models import model as JM
    from repro_torch.models import model as TM
    want_logits, _, _ = JM.forward(jparams, jarch.cfg, jnp.asarray(toks))
    got_logits, _, _ = TM.forward(tparams, tarch.cfg,
                                  torch.from_numpy(toks).long())
    _close(got_logits, want_logits, 1e-5, 1e-5)
    want_loss, _ = jarch.loss(jparams, {"tokens": jnp.asarray(toks)})
    got_loss, aux = tarch.loss(tparams,
                               {"tokens": torch.from_numpy(toks).long()})
    _close(got_loss, want_loss, 1e-5, 1e-5)
    assert float(aux["loss"]) == float(got_loss)


@pytest.mark.parametrize("name", ARCHS)
def test_gradients(name):
    jarch, jparams, tarch, tparams = _models(name)
    toks = _tokens(jarch.cfg.vocab_size, seed=7)
    want = jax.grad(lambda p: jarch.loss(p, {"tokens": jnp.asarray(toks)})[0]
                    )(jparams)
    req = tree.map(lambda t: t.requires_grad_(True), tparams)
    loss, _ = tarch.loss(req, {"tokens": torch.from_numpy(toks).long()})
    grads = tree.unflatten(req, torch.autograd.grad(loss, tree.leaves(req)))
    want_np = dict(tree.paths(jax.tree.map(np.asarray, want)))
    got = tree.paths(grads)
    assert [p for p, _ in got] == sorted(want_np)
    for path, g in got:
        np.testing.assert_allclose(g.numpy(), want_np[path], rtol=1e-4,
                                   atol=1e-6, err_msg=path)
