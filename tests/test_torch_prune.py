"""The port's per-neuron sign pruning (paper Table 6) against the JAX
package's.

On the CPU the kernel wrapper runs its plain version; it is held bit for
bit to the JAX oracle (``kernels/ref.py``) and to the Pallas kernel in
interpret mode: the threshold comes from integer counts and an exact max,
so it does not depend on summation order, and the two magnitude sums that
elect the sign only matter on a tie to the last bit. The CUDA kernels are
held to the plain version on the card (``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import compression as JC  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sign_prune as JSP  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sign_prune as TSP  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
# C a multiple of 128 and not; single rows; (3, 5) and (2, 7) put
# (1 - frac)·C on a half, where round() goes to even
SHAPES = [(1, 896), (5, 128), (7, 300), (3, 1000), (12, 2048), (1, 1),
          (3, 5), (2, 7)]
FRACS = [0.25, 0.5, 0.9]


def _x(shape, seed, zeros=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if zeros:
        x[rng.random(shape) < 0.2] = 0.0
    return x


@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sign_prune_plain_matches_jax(shape, frac):
    x = _x(shape, shape[0] * shape[1])
    want_ref = np.asarray(jref.sign_prune(jnp.asarray(x), frac))
    want_pallas = np.asarray(JSP.sign_prune(jnp.asarray(x), frac,
                                            interpret=True))
    got = TSP.sign_prune_(torch.from_numpy(x.copy()), frac).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  want_ref.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32),
                                  want_pallas.view(np.int32))


def test_sign_prune_parts_and_zeros():
    """The per-row sign and threshold the kernels are held to; zeros
    (sign 0) are never kept; keep_count rounds half to even."""
    x = _x((6, 300), 1, zeros=True)
    sign, hi, out = TSP.sign_prune_parts(torch.from_numpy(x), 0.5)
    want = np.asarray(jref.sign_prune(jnp.asarray(x), 0.5))
    np.testing.assert_array_equal(out.numpy(), want)
    mag = np.abs(x)
    want_hi = np.asarray(jref.bisect_threshold(jnp.asarray(mag),
                                               tref.keep_count(0.5, 300)))
    np.testing.assert_array_equal(hi.numpy(), want_hi)
    pos = np.where(x > 0, mag, 0).sum(-1)
    neg = np.where(x < 0, mag, 0).sum(-1)
    np.testing.assert_array_equal(sign.numpy()[:, 0],
                                  np.where(pos >= neg, 1.0, -1.0))
    kept = out.numpy() != 0
    assert not (kept & (x == 0)).any()
    assert (np.sign(x[kept]) == np.repeat(sign.numpy(), 300, 1)[kept]).all()
    assert [tref.keep_count(0.5, c) for c in (5, 7, 1)] == [2, 4, 1]
    assert tref.keep_count(1.0, 100) == 1


def test_sign_prune_tree_matches_jax():
    """A smoke model's shapes as an outer-gradient tree: every leaf as
    (leading dim, rest), 1-D leaves as one row, a 0-d leaf untouched."""
    jarch = jreg.get_smoke_arch("diloco_150m")
    params = jax.tree.map(np.asarray, jarch.init(jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(3)
    delta = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32), params)
    delta["scalar"] = np.float32(0.5)
    want = jax.tree.map(np.asarray, jops.sign_prune_tree(
        jax.tree.map(jnp.asarray, delta), 0.5, mode="ref"))
    got = TC.sign_prune(convert.params_from_numpy(delta, device="cpu"), 0.5)
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    np.testing.assert_allclose(float(TC.density(got)),
                               float(JC.density(jax.tree.map(jnp.asarray,
                                                             want))),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_sign_prune_matrix_matches_jax(mode):
    """The matrix form of ``core.compression``: pruned in place, equal to
    the JAX ``compression.sign_prune_matrix``."""
    x = _x((9, 260), 7, zeros=True)
    want = np.asarray(JC.sign_prune_matrix(jnp.asarray(x), 0.5, mode="ref"))
    t = torch.from_numpy(x.copy())
    assert TC.sign_prune_matrix(t, 0.5, mode=mode) is t
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("mode", ["auto", "ref"])
def test_stacked_pruning_equals_jax_vmap(mode):
    """Stacked (k, ...) leaves pruned in place as one (k·R, C) matrix each
    equal the JAX vmap over the replicas of the per-replica rule."""
    k = 3
    shapes = {"w": (k, 4, 6, 5), "v": (k, 33), "s": (k,)}
    rng = np.random.default_rng(4)
    delta = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    want = jax.vmap(lambda d: jops.sign_prune_tree(d, 0.5, mode="ref"))(
        jax.tree.map(jnp.asarray, delta))
    tdelta = convert.params_from_numpy(delta, device="cpu")
    leaves = dict(tdelta)
    got = tops.sign_prune_tree(tdelta, 0.5, stacked=True, mode=mode)
    assert got is tdelta
    for n in shapes:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        assert got[n] is leaves[n]
    # a leaf with no dim past the replicas' is left as it is
    np.testing.assert_array_equal(got["s"].numpy(), delta["s"])
    with pytest.raises(ValueError, match="contiguous"):
        tops.sign_prune_tree({"w": torch.ones(2, 3, 4).transpose(1, 2)},
                             0.5, stacked=True, mode=mode)


def test_prune_wrapper_checks_and_counts():
    x = torch.from_numpy(_x((4, 10), 5))
    y = x.clone()
    assert TSP.sign_prune_(y, 0.0) is y and TSP.sign_prune_(y, -1.0) is y
    assert torch.equal(y, x)
    with pytest.raises(ValueError, match="matrix"):
        TSP.sign_prune_(x.reshape(-1), 0.5)
    with pytest.raises(ValueError, match="kernel"):
        tops.sign_prune(x, 0.5, mode="kernel")
    before = TSP.launches
    assert TSP.sign_prune_(y, 0.5) is y
    assert torch.equal(y, TSP.sign_prune_parts(x, 0.5)[2])
    assert TSP.launches == before          # the plain version on the CPU
    # the launches the kernels take, by regime
    assert TSP.launches_for(64000, 896) == 1
    assert TSP.launches_for(1792, 32000) == 1
    assert TSP.launches_for(24, 917_504) == 5
    assert TSP.launches_for(0, 10) == 0


def test_round_with_pruning_matches_jax():
    """A float32 round with prune_frac=0.5 (k=2, H=2): every leaf within
    the f32 round tolerance of the JAX round (kernel_mode ref)."""
    jarch = jreg.get_smoke_arch("diloco_150m")
    k, H, B, S = 2, 2, 2, 16
    tcfg = dict(inner_lr=1e-3, warmup_steps=2, total_steps=16)
    params, _ = jarch.init(jax.random.PRNGKey(1))
    jd = JDCfg(k=k, H=H, prune_frac=0.5)
    jstate0 = JD.init_state(params, jd)
    sampler = JMarkov(vocab_size=jarch.cfg.vocab_size, k=k, seed=0)
    key = jax.random.PRNGKey(3)
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(
            jax.random.split(key, H)), 0, 1)[:k])
    jstate, jm = JD.make_round(lambda p, b: jarch.loss(p, b),
                               sampler.sample_all_shards, jd,
                               JTCfg(**tcfg), batch_size=B,
                               seq_len=S)(jstate0, key)
    tarch = treg.get_smoke_arch("diloco_150m")
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate0),
                                     device="cpu")
    flat = torch.from_numpy(toks).long().reshape(k, H * B, S)
    rnd = TD.make_round(lambda p, b: tarch.loss(p, b), lambda g, b, s: flat,
                        DiLoCoConfig(k=k, H=H, prune_frac=0.5),
                        TrainConfig(**tcfg), batch_size=B, seq_len=S)
    state, tm = rnd(state, None)
    js = jax.tree.map(np.asarray, jstate)
    want = {"global_params": js.global_params,
            "outer_state": {"buf": js.outer_state.buf,
                            "buf2": js.outer_state.buf2,
                            "count": js.outer_state.count},
            "replica_params": js.replica_params,
            "inner_state": {"m": js.inner_state.m, "v": js.inner_state.v,
                            "count": js.inner_state.count},
            "outer_t": js.outer_t, "inner_steps_done": js.inner_steps_done}
    got = convert.state_to_numpy(state)
    assert [p for p, _ in tree.paths(got)] == [p for p, _ in
                                               tree.paths(want)]
    for (path, a), (_, b) in zip(tree.paths(got), tree.paths(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=path)
    np.testing.assert_allclose(float(tm["outer_gnorm"]),
                               float(jm["outer_gnorm"]), rtol=1e-4)
    assert 0.0 < float(tm["prune_density"]) <= 0.5
