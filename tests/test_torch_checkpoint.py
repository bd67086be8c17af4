"""The port's checkpoint files against the JAX package's
(``checkpoint/checkpoint.py``): the same flat keys, the same bf16
sentinel, so a DiLoCo state written by either package restores in the
other bit for bit, and ``tree_sha256`` of a port state equals the JAX
package's digest of the same state.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import resilience as jres  # noqa: E402
from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.core import streaming as JS  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert, resilience, tree  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.core import streaming as TS  # noqa: E402

CASES = {
    "f32": dict(k=2),
    "mixed": dict(k=2, param_dtype="bfloat16", master_dtype="float32"),
    "stream": dict(k=2, streaming_fragments=2, outer_grad_dtype="int4",
                   error_feedback=True),
}


def _jax_state(case):
    """A JAX state of the smoke config with every float leaf filled with
    seeded values (at the leaf's dtype) and non-zero step counters."""
    params, _ = jreg.get_smoke_arch("diloco_150m").init(
        jax.random.PRNGKey(0))
    dcfg = JDCfg(**CASES[case])
    st = (JS.init_state(params, dcfg) if dcfg.streaming_fragments
          else JD.init_state(params, dcfg))
    rng = np.random.default_rng(3)
    fill = lambda x: (jnp.asarray(rng.standard_normal(x.shape), x.dtype)
                      if jnp.issubdtype(x.dtype, jnp.floating)
                      else x + 3)
    return jax.tree.map(fill, st), dcfg


def _port_state(jstate_np, case):
    if CASES[case].get("streaming_fragments"):
        return convert.stream_state_from_numpy(
            jstate_np, DiLoCoConfig(**CASES[case]), device="cpu")
    return convert.state_from_numpy(jstate_np, device="cpu")


def _port_example(case):
    """The port's own fresh state of the same config (other values)."""
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jreg.get_smoke_arch("diloco_150m").init(
            jax.random.PRNGKey(9))[0]), device="cpu")
    dcfg = DiLoCoConfig(**CASES[case])
    if dcfg.streaming_fragments:
        return TS.init_state(params, dcfg)
    return TD.init_state(params, dcfg)


def _np_leaves(t):
    """(path, numpy array) of a port tree, in its flat-key order."""
    return [(ckpt.key_of(p), ckpt._host(x)[0])
            for p, x in tree.flatten_with_path(t)]


def _jax_np_leaves(t):
    flat = jckpt._flatten(t)
    return [(k, a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
            for k, a in flat.items()]


@pytest.mark.parametrize("case", list(CASES))
def test_jax_snapshot_restores_in_port(tmp_path, case):
    jstate, _ = _jax_state(case)
    path = str(tmp_path / "j.npz")
    jckpt.save(path, jres.wrap(jstate, jax.random.PRNGKey(4), 2))
    got = ckpt.restore(path, {"state": _port_example(case)})["state"]
    want = _jax_np_leaves(jstate)
    assert [k for k, _ in _np_leaves(got)] == [k for k, _ in want]
    for (key, a), (_, b) in zip(_np_leaves(got), want):
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert isinstance(got.outer_t, int) and got.outer_t == 3


@pytest.mark.parametrize("case", list(CASES))
def test_port_snapshot_restores_in_jax(tmp_path, case):
    jstate, _ = _jax_state(case)
    port = _port_state(jax.tree.map(np.asarray, jstate), case)
    path = str(tmp_path / "t.npz")
    stats = ckpt.save(path, resilience.wrap(port, np.zeros(16, np.uint8),
                                            2))
    assert stats["bytes"] == sum(a.nbytes for a in np.load(path).values())
    example = jax.tree.map(jnp.zeros_like, jstate)
    back = jckpt.restore(path, {"state": example})["state"]
    for (key, a), (_, b) in zip(_jax_np_leaves(back),
                                _jax_np_leaves(jstate)):
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_tree_sha256_equals_jax(case):
    """The digest and the per-leaf digests of a port state equal the JAX
    package's of the same state handed over as numpy."""
    jstate, _ = _jax_state(case)
    jnp_state = jax.tree.map(np.asarray, jstate)
    port = _port_state(jnp_state, case)
    assert resilience.leaf_hashes(port) == jres.leaf_hashes(jnp_state)
    assert resilience.tree_sha256(port) == jres.tree_sha256(jnp_state)
    env = resilience.wrap(port, np.arange(4, dtype=np.uint8), 3)
    jenv = jres.wrap(jnp_state, np.arange(4, dtype=np.uint8), 3)
    assert resilience.tree_sha256(env) == jres.tree_sha256(jenv)


def test_bf16_round_trip_through_sentinel(tmp_path):
    """bf16 tensors are stored as uint16 bits named under
    ``__leaf_dtypes__``, as the JAX package stores its bf16 leaves, and
    come back bit for bit (by example, by ``restore_tree``, in JAX)."""
    bits = np.random.default_rng(0).integers(0, 2 ** 16, (5, 3),
                                             dtype=np.uint16)
    t = {"h": convert.tensor_from_numpy(bits, device="cpu"),
         "w": torch.arange(4.0), "n": 7}
    path = str(tmp_path / "b.npz")
    ckpt.save(path, t)
    with np.load(path) as data:
        assert data["h"].dtype == np.uint16
        assert data["__leaf_dtypes__"].tolist() == ["h=bfloat16"]
        assert data["n"].dtype == np.int32
    back = ckpt.restore(path, {"h": torch.zeros(5, 3, dtype=torch.bfloat16),
                               "w": torch.zeros(4), "n": 0})
    assert back["h"].dtype == torch.bfloat16 and back["n"] == 7
    np.testing.assert_array_equal(convert.tensor_to_numpy(back["h"]), bits)
    flat = ckpt.restore_tree(path)
    np.testing.assert_array_equal(convert.tensor_to_numpy(flat["h"]), bits)
    j = jckpt.restore_tree(path)
    assert j["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(j["h"]).view(np.uint16), bits)


def test_restore_in_place_and_reshape_like(tmp_path):
    """``in_place`` overwrites the example's tensors; ``reshape_like`` puts
    a ``restore_tree`` view back on the NamedTuple structure."""
    jstate, _ = _jax_state("f32")
    port = _port_state(jax.tree.map(np.asarray, jstate), "f32")
    path = str(tmp_path / "s.npz")
    ckpt.save(path, port)
    example = _port_example("f32")
    leaf = example.global_params["embed"]["table"]
    back = ckpt.restore(path, example, in_place=True)
    assert back.global_params["embed"]["table"] is leaf
    assert resilience.tree_sha256(back) == resilience.tree_sha256(port)
    view = ckpt.reshape_like(ckpt.restore_tree(path), example)
    assert type(view) is TD.DiLoCoState and view.outer_t == 3
    assert resilience.tree_sha256(view) == resilience.tree_sha256(port)


@pytest.mark.parametrize("bad", ["shape", "key"])
def test_mismatch_rejected(tmp_path, bad):
    path = str(tmp_path / "m.npz")
    ckpt.save(path, {"w": torch.ones(4), "b": torch.zeros(2)})
    if bad == "shape":
        with pytest.raises(ValueError, match="shape mismatch for w"):
            ckpt.restore(path, {"w": torch.ones(5), "b": torch.zeros(2)})
    else:
        with pytest.raises(KeyError, match="extra"):
            ckpt.restore(path, {"w": torch.ones(4), "extra": torch.ones(1)})


def test_wrap_unwrap_and_format(tmp_path):
    gen = torch.Generator().manual_seed(5)
    env = resilience.wrap({"w": torch.ones(2)}, gen, 4)
    path = str(tmp_path / "e.npz")
    ckpt.save(path, env)
    st, key, done = resilience.unwrap(ckpt.restore(path, env))
    assert done == 4 and torch.equal(key, gen.get_state())
    env["cursor"]["format"] = np.int32(2)
    with pytest.raises(ValueError, match="format 2"):
        resilience.unwrap(env)
    ckpt.atomic_write_json(str(tmp_path / "x.json"), {"a": 1}, indent=2)
    assert (tmp_path / "x.json").read_text() == '{\n  "a": 1\n}'
