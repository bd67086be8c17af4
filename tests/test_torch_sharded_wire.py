"""The sharded transport's wire and its rounds against references that
need no JAX round: the packed wire's masked mean against the JAX
package's (``tests/test_pod_collectives.py::_packed_mean_tree``, whose own
test ``test_packed_wire_mean_matches_simulated`` passes), and the port's
sharded rounds against its own simulated rounds. The ranks are gloo
processes on the CPU (``launch/mesh.spawn``).

Packed mean: per fragment, each region of the band encoded (int4 codes
and scales, or bf16), ONE gather of the coalesced buffer, decode and
masked mean. The wire bytes are the JAX encoder's (``tests/
test_torch_wire.py``); the reduce sums in replica order where JAX's
tensordot takes its own, so the means agree within rtol 1e-6, atol 1e-7
(JAX's own bound for its bf16 packed mean against the simulated one).

Rounds, the sharded transport against the simulated one on the same
tokens and state:
  * float32 with one replica per rank and 0/1 masks: bit for bit (the
    products are exact and a two-rank all-reduce is the simulated sum);
  * float32 with two replicas per rank: the ranks' partial sums regroup
    the simulated sum, so the state agrees within atol 1e-6 (the runs
    read at most 1.2e-7 after two rounds);
  * int4 without the packed wire (``pack_wire=False``, the fake-quant
    payload gathered as float32) and bf16 on the packed wire (real bf16
    bits on the wire): bit for bit, in-flight payloads included (the
    gathered values are the simulated payloads, reduced in the same
    order).
The packed int4 wire differs from the simulated transport by design (its
scale blocks start at each region, as the JAX packed sender's): it is
held to the JAX sharded round in ``tests/test_torch_sharded.py``.
Sharding a state over the ranks and gathering it back is exact.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import diloco, streaming  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models.registry import Arch  # noqa: E402
from test_pod_collectives import _packed_mean_tree, _toy_tree  # noqa: E402

torch.set_num_threads(2)
H, B, S, VOCAB, R = 4, 2, 16, 64, 2
TINY = dict(name="tiny", family="dense", n_layers=4, d_model=40, n_heads=2,
            n_kv_heads=2, d_ff=72, vocab_size=VOCAB, remat=False,
            attn_chunk=32)
TCFG = TrainConfig(inner_lr=3e-3, warmup_steps=2, total_steps=R * H,
                   batch_size=B, seq_len=S)


@pytest.mark.parametrize("pods", [2, 4])
def test_packed_mean_matches_jax(pods):
    """P ∈ {1, 2}, int4 and bf16, k = pods replicas, a zero mask entry."""
    params = _toy_tree()
    k = pods
    rng = np.random.default_rng(pods)
    d = {name: rng.normal(size=(k,) + np.asarray(l).shape).astype(
        np.float32) for name, l in params.items()}
    m = (rng.random(k) > 0.3).astype(np.float32)
    m[0], m[-1] = 1.0, 0.0
    cases = [(P, dt) for P in (1, 2) for dt in ("int4", "bfloat16")]
    got = mesh.spawn(
        "repro_torch.launch.pod_rounds:packed_means",
        mesh.make_pod_layout(pods, "cpu"),
        {n: torch.from_numpy(np.array(l)) for n, l in params.items()},
        {n: torch.from_numpy(x) for n, x in d.items()}, m, cases)[0]
    for P, dt in cases:
        want = _packed_mean_tree(params, {n: jnp.asarray(x)
                                          for n, x in d.items()},
                                 jnp.asarray(m), P, pods, dt)
        for name in params:
            np.testing.assert_allclose(got[(P, dt)][name],
                                       np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{P} {dt} {name}")


def _masks(k):
    """0/1 drop, active and weight masks: all in, then replica 1 dropped
    and the last inactive."""
    ones = np.ones(k, np.float32)
    drop = ones.copy()
    drop[1] = 0.0
    act = ones.copy()
    act[-1] = 0.0
    return [(ones, ones, ones), (drop, act, ones)]


def _simulated(params, dcfg, toks, masks):
    arch = Arch(cfg=ModelConfig(**TINY))
    st = streaming.init_state(tree.map(torch.clone, params), dcfg)
    rnd = diloco.make_round(lambda p, b: arch.loss(p, b),
                            lambda r, b, s: toks[r], dcfg, TCFG,
                            batch_size=B, seq_len=S)
    for r, (d, a, w) in enumerate(masks):
        st, _ = rnd(st, r, d, a, w)
    return st


def _sharded(params, kw, pods, toks, masks, state=None):
    return mesh.spawn("repro_torch.launch.pod_rounds:rounds",
                      mesh.make_pod_layout(pods, "cpu"),
                      ModelConfig(**TINY),
                      DiLoCoConfig(transport="sharded", **kw), TCFG, toks,
                      masks, params, state)


def _params():
    arch = Arch(cfg=ModelConfig(**TINY))
    return arch.init(generator=torch.Generator().manual_seed(0),
                     device="cpu")


@pytest.mark.parametrize("k,pods,dtype,tau,pack,atol", [
    (2, 2, "float32", 0, True, 0.0),
    (4, 2, "float32", 1, True, 1e-6),
    (2, 2, "int4", 1, False, 0.0),
    (4, 2, "bfloat16", 1, True, 0.0),
])
def test_sharded_rounds_match_simulated(k, pods, dtype, tau, pack, atol):
    params = _params()
    toks = torch.randint(0, VOCAB, (R, k, H * B, S),
                         generator=torch.Generator().manual_seed(k))
    kw = dict(k=k, H=H, streaming_fragments=2, stream_tau=tau,
              stream_alpha=0.5, outer_grad_dtype=dtype,
              error_feedback=dtype != "float32", pack_wire=pack)
    masks = _masks(k)
    want_st = _simulated(params, DiLoCoConfig(**kw), toks, masks)
    want = convert.stream_state_to_numpy(want_st)
    res = _sharded(params, kw, pods, toks, masks)
    got = res[0]["state"]
    assert len({r["shared"] for r in res}) == 1
    pw, pg = dict(tree.paths(want)), dict(tree.paths(got))
    assert sorted(pw) == sorted(pg)
    for path, b in pw.items():
        a = pg[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if atol == 0.0 or not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                       err_msg=path)


def test_shard_then_gather_is_exact():
    """A state after a round (its in-flight payloads live) banded over 4
    ranks and gathered back without a round: every leaf bit for bit."""
    k = 4
    params = _params()
    kw = dict(k=k, H=H, streaming_fragments=2, stream_tau=1,
              stream_alpha=0.5, outer_grad_dtype="int4",
              error_feedback=True, pack_wire=False)
    toks = torch.randint(0, VOCAB, (1, k, H * B, S),
                         generator=torch.Generator().manual_seed(3))
    full = _simulated(params, DiLoCoConfig(**kw), toks, _masks(k)[1:])
    # copies: handing ``full`` to the ranks moves its storage to shared
    # memory, which the numpy views would not follow
    want = tree.map(np.array, convert.stream_state_to_numpy(full))
    res = _sharded(None, kw, 4, toks, [], state=full)
    got = res[0]["state"]
    for (pa, a), (pb, b) in zip(tree.paths(got), tree.paths(want)):
        assert pa == pb
        np.testing.assert_array_equal(a, b, err_msg=pa)
    assert all(r["traffic"]["wire_bytes"] == 0 for r in res)
