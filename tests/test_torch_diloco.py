"""The port's DiLoCo round and outer optimizers against the JAX package's.

A round starts from one state, made by the JAX ``init_state`` from JAX
params, and both packages train on the tokens the JAX sampler drew, so
every leaf of the resulting state can be compared. The JAX round runs in
its default ``ref`` kernel mode (the legacy tree maps); the port runs its
default ``auto`` mode, which on CPU tensors is the plain version of the
CUDA kernels.

Round tolerance atol 1e-5, rtol 1e-4: the matmuls and the gradient norm
reduce in another order, and AdamW's m/√v normalises those last-bit
differences of the gradients up to the update's scale (lr 1e-3 here).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.configs.base import TrainConfig as JTCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.core import outer_opt as JO  # noqa: E402
from repro.data.pipeline import MarkovMixture as JMarkov  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.core import outer_opt as TO  # noqa: E402
from repro_torch.kernels import fused_adamw as TFA  # noqa: E402
from repro_torch.kernels import outer_nesterov as TON  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 16
TCFG = dict(inner_lr=1e-3, warmup_steps=2, total_steps=16)


def _jax_state_np(state):
    """A JAX DiLoCoState as the nested numpy dict of
    ``convert.state_to_numpy``."""
    s = jax.tree.map(np.asarray, state)
    return {"global_params": s.global_params,
            "outer_state": {"buf": s.outer_state.buf,
                            "buf2": s.outer_state.buf2,
                            "count": s.outer_state.count},
            "replica_params": s.replica_params,
            "inner_state": {"m": s.inner_state.m, "v": s.inner_state.v,
                            "count": s.inner_state.count},
            "outer_t": s.outer_t, "inner_steps_done": s.inner_steps_done}


def _assert_states_close(got, want, rtol=RTOL, atol=ATOL):
    got, want = tree.paths(got), dict(tree.paths(want))
    assert sorted(p for p, _ in got) == sorted(want)
    for path, a in got:
        np.testing.assert_allclose(a, want[path], rtol=rtol, atol=atol,
                                   err_msg=path)


def _rounds(k, H, *, masks=None, modes=("auto",), arch="diloco_150m"):
    """One JAX round and one port round per kernel mode, from the same
    state and tokens. Returns (jax state np, {mode: port state np},
    jax metrics, {mode: port metrics})."""
    jarch = jreg.get_smoke_arch(arch)
    tarch = treg.get_smoke_arch(arch)
    params, _ = jarch.init(jax.random.PRNGKey(1))
    jd = JDCfg(k=k, H=H)
    jstate0 = JD.init_state(params, jd)
    sampler = JMarkov(vocab_size=jarch.cfg.vocab_size, k=k, seed=0)
    key = jax.random.PRNGKey(3)
    # the tokens the JAX round draws from ``key``: (k, H, B, S)
    keys = jax.random.split(key, H)
    toks = np.array(jnp.swapaxes(jax.vmap(
        lambda kk: sampler.sample_all_shards(kk, B, S))(keys), 0, 1)[:k])
    masks = masks or {}
    jrnd = JD.make_round(lambda p, b: jarch.loss(p, b),
                         sampler.sample_all_shards, jd, JTCfg(**TCFG),
                         batch_size=B, seq_len=S)
    jstate, jm = jrnd(jstate0, key,
                      *(None if masks.get(n) is None
                        else jnp.asarray(masks[n])
                        for n in ("drop", "active", "weights")))
    np_state0 = jax.tree.map(np.asarray, jstate0)
    got, tm = {}, {}
    for mode in modes:
        state = convert.state_from_numpy(np_state0, device="cpu")
        flat = torch.from_numpy(toks).long().reshape(k, H * B, S)
        rnd = TD.make_round(lambda p, b: tarch.loss(p, b),
                            lambda g, b, s: flat,
                            DiLoCoConfig(k=k, H=H, kernel_mode=mode),
                            TrainConfig(kernel_mode=mode, **TCFG),
                            batch_size=B, seq_len=S)
        state, tm[mode] = rnd(state, None, masks.get("drop"),
                              masks.get("active"), masks.get("weights"))
        got[mode] = convert.state_to_numpy(state)
    return _jax_state_np(jstate), got, jm, tm


def test_round_matches_jax():
    """k=2, H=4: every leaf of the state after one round."""
    want, got, jm, tm = _rounds(2, 4)
    _assert_states_close(got["auto"], want)
    for name in ("inner_loss", "inner_loss_last", "outer_gnorm"):
        np.testing.assert_allclose(float(tm["auto"][name]), float(jm[name]),
                                   rtol=RTOL, atol=ATOL)


def test_round_with_masks_matches_jax():
    """k=3: replica 1's outer gradient is dropped (it keeps its own
    params), replica 2 is inactive (skipped, parked on the new global),
    and the outer average is weighted by shard size."""
    masks = {"drop": np.array([1, 0, 1], np.float32),
             "active": np.array([1, 1, 0], np.float32),
             "weights": np.array([0.5, 0.3, 0.2], np.float32)}
    want, got, jm, tm = _rounds(3, 2, masks=masks)
    _assert_states_close(got["auto"], want)
    assert list(got["auto"]["inner_state"]["count"]) == [2, 2, 0]
    np.testing.assert_allclose(float(tm["auto"]["outer_gnorm"]),
                               float(jm["outer_gnorm"]), rtol=RTOL)
    # the inactive replica's losses are its frozen params' on its batches
    for name in ("inner_loss", "inner_loss_last"):
        np.testing.assert_allclose(float(tm["auto"][name]), float(jm[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_ref_and_auto_modes_agree():
    """``ref`` (the legacy tree maps: g squared first) and ``auto`` (the
    kernel's plain version: (1-b2)·g times g) differ by an ulp in v;
    rtol 1e-5, atol 1e-7 after H=2 steps."""
    _, got, _, _ = _rounds(2, 2, modes=("ref", "auto"))
    _assert_states_close(got["auto"], got["ref"], rtol=1e-5, atol=1e-7)


def test_round_launch_counts_on_cpu():
    """On CPU tensors the default mode runs the plain versions: no kernel
    launch is counted."""
    a0, n0 = dict(TFA.launches), TON.launches
    _rounds(2, 1)
    assert (TFA.launches, TON.launches) == (a0, n0)


def _outer_trees(seed):
    rng = np.random.default_rng(seed)
    mk = lambda scale: {"a": {"w": np.asarray(rng.standard_normal((6, 5)),
                                              np.float32) * scale},
                        "b": np.asarray(rng.standard_normal((33,)),
                                        np.float32) * scale}
    return mk(1.0), mk(np.float32(1e-2)), mk(np.float32(1e-2))


@pytest.mark.parametrize("kind,mode", [("nesterov", "auto"),
                                       ("nesterov", "ref"), ("sgd", "auto"),
                                       ("sgdm", "auto"), ("adam", "auto")])
def test_outer_optimizers_match_jax(kind, mode):
    """Two consecutive outer steps (so the momenta and Adam's count are
    live), rtol 1e-6, atol 1e-7: the elementwise order is the JAX one."""
    params, d1, d2 = _outer_trees(11)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init(jp)
    tp = convert.params_from_numpy(params, device="cpu")
    ts = TO.init(tp)
    for d in (d1, d2):
        jp, js = JO.update(jax.tree.map(jnp.asarray, d), js, jp, kind=kind,
                           lr=0.7, momentum=0.9, eps=0.1)
        tp, ts = TO.update(convert.params_from_numpy(d, device="cpu"), ts,
                           tp, kind=kind, lr=0.7, momentum=0.9, eps=0.1,
                           kernel_mode=mode)
    assert ts.count == int(js.count) == 2
    for got, want in ((tp, jp), (ts.buf, js.buf), (ts.buf2, js.buf2)):
        for (path, a), (_, b) in zip(tree.paths(got), tree.paths(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7,
                                       err_msg=path)


def test_outer_wire_bytes_and_eval_match_jax():
    jarch = jreg.get_smoke_arch("diloco_150m")
    params, _ = jarch.init(jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    assert TD.outer_wire_bytes(tparams, DiLoCoConfig(k=2)) == \
        JD.outer_wire_bytes(params, JDCfg(k=2))
    toks = np.random.default_rng(0).integers(0, 256, (2, S)).astype(np.int32)
    want = JD.make_eval(lambda p, b: jarch.loss(p, b))(params,
                                                       jnp.asarray(toks))
    tarch = treg.get_smoke_arch("diloco_150m")
    got = TD.make_eval(lambda p, b: tarch.loss(p, b))(
        tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_unported_features_raise():
    """Features still unported raise and name their ROADMAP.md item;
    pruning, both bf16 policies, streaming and gossip (ported) build a
    round, the sharded transport (ported) only on a pod group and on the
    streaming round, gossip only without one; a quantized outer gradient
    off the streaming round is refused; a state layout that disagrees
    with the inner step's policy is refused."""
    loss = lambda p, b: (0.0, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TD.make_round(loss, None, DiLoCoConfig(sync_inner_state=True),
                      TrainConfig())
    TD.make_round(loss, None, DiLoCoConfig(transport="gossip"),
                  TrainConfig())
    with pytest.raises(ValueError, match="drop group="):
        TD.make_round(loss, None, DiLoCoConfig(transport="gossip"),
                      TrainConfig(), group=object())
    with pytest.raises(ValueError, match="pod group"):
        TD.make_round(loss, None, DiLoCoConfig(streaming_fragments=2,
                                               transport="sharded"),
                      TrainConfig())
    with pytest.raises(ValueError, match="streaming-path feature"):
        TD.make_round(loss, None, DiLoCoConfig(transport="sharded"),
                      TrainConfig())
    with pytest.raises(NotImplementedError, match="streaming_fragments"):
        TD.make_round(loss, None, DiLoCoConfig(outer_grad_dtype="int4"),
                      TrainConfig())
    TD.make_round(loss, None,
                  DiLoCoConfig(streaming_fragments=2, outer_grad_dtype="int4",
                               error_feedback=True, stream_tau=1),
                  TrainConfig())
    for pdt, mdt in (("bfloat16", "float32"), ("bfloat16", "bfloat16")):
        TD.make_round(loss, None,
                      DiLoCoConfig(param_dtype=pdt, master_dtype=mdt,
                                   prune_frac=0.5),
                      TrainConfig(param_dtype=pdt, master_dtype=mdt))
    with pytest.raises(ValueError, match="disagree"):
        TD.make_round(loss, None, DiLoCoConfig(param_dtype="bfloat16"),
                      TrainConfig(param_dtype="bfloat16",
                                  master_dtype="bfloat16"))


@pytest.mark.parametrize("kind", ["constant_local", "constant_distributed",
                                  "doubling", "halving", "ramp_up",
                                  "ramp_down"])
def test_schedules_match_jax(kind):
    from repro.core import schedules as JSch
    from repro_torch.core import schedules as TSch
    n = TSch.compute_schedule(kind, 4, 7)
    np.testing.assert_array_equal(n, JSch.compute_schedule(kind, 4, 7))
    np.testing.assert_array_equal(TSch.active_masks(n, 4),
                                  JSch.active_masks(n, 4))
    assert TSch.total_compute(n, 5) == JSch.total_compute(n, 5)
    np.testing.assert_array_equal(
        TSch.drop_masks(np.random.default_rng(1), 0.3, 4, 7),
        JSch.drop_masks(np.random.default_rng(1), 0.3, 4, 7))


def test_precision_policy():
    from repro_torch.optim import precision
    pol = precision.make_policy()
    assert pol == precision.policy_of(TrainConfig()) and not pol.mixed
    mixed = precision.make_policy("bfloat16", "float32")
    assert mixed == (torch.bfloat16, torch.float32) and mixed.mixed
    pure = precision.policy_of(TrainConfig(param_dtype="bfloat16",
                                           master_dtype="bfloat16"))
    assert pure == (torch.bfloat16, torch.bfloat16) and not pure.mixed
    with pytest.raises(ValueError):
        precision.make_policy("float32", "bfloat16")
    with pytest.raises(ValueError):
        precision.make_policy("float16", "float32")
    t = {"a": torch.ones(3)}
    assert precision.cast_tree(t, torch.float32)["a"] is t["a"]
    fresh = precision.cast_tree(t, torch.float32, fresh=True)["a"]
    assert fresh is not t["a"] and torch.equal(fresh, t["a"])
