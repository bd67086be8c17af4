"""The port's ``CheckpointManager`` against the JAX package's: the same
snapshot files and manifests, so a snapshot written by either verifies
in the other; both find truncation, bit rot and a missing manifest, fall
back past them in ``latest_good``, and keep the same snapshots under
retention.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.resilience import CheckpointManager as JManager  # noqa: E402
from repro_torch import convert, resilience  # noqa: E402
from repro_torch.resilience import CheckpointManager, harness  # noqa: E402


def port_tree(step: int) -> dict:
    """f32, a host int, bf16 and a nested dict, varying with ``step``."""
    return {"w": torch.arange(8.0) + step, "t": step,
            "half": torch.ones(3, dtype=torch.bfloat16) * (1 + step),
            "nest": {"b": torch.zeros(2, 2) + step}}


def jax_tree(step: int) -> dict:
    """``port_tree(step)`` as the JAX package holds it."""
    return {"w": jnp.arange(8.0) + step, "t": jnp.asarray(step, jnp.int32),
            "half": jnp.ones((3,), jnp.bfloat16) * (1 + step),
            "nest": {"b": jnp.zeros((2, 2)) + step}}


def _manifest(mgr, step) -> dict:
    with open(mgr.path_of(step) + ".manifest.json") as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshot_verifies_in_the_other_package(tmp_path, writer):
    """A snapshot written by one package verifies in the other, with the
    same manifest the other would write, and restores there."""
    port, jx = (CheckpointManager(str(tmp_path / "p")),
                JManager(str(tmp_path / "j")))
    port.save(4, port_tree(4))
    jx.save(4, jax_tree(4))
    assert _manifest(port, 4) == _manifest(jx, 4)
    d = str(tmp_path / ("p" if writer == "port" else "j"))
    assert CheckpointManager(d).verify(4) and JManager(d).verify(4)
    back = CheckpointManager(d).load(4, port_tree(0))
    assert resilience.tree_sha256(back) == resilience.tree_sha256(
        port_tree(4))
    jback = JManager(d).load(4, jax_tree(0))
    np.testing.assert_array_equal(np.asarray(jback["half"]).view(np.uint16),
                                  convert.tensor_to_numpy(
                                      port_tree(4)["half"]))


@pytest.mark.parametrize("mode", ["truncate", "bitflip"])
def test_corruption_caught_by_both(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, port_tree(1))
    mgr.save(2, port_tree(2))
    assert mgr.latest_good() == 2
    assert harness.corrupt_latest(str(tmp_path), mode=mode) == \
        mgr.path_of(2)
    jx = JManager(str(tmp_path))
    assert not mgr.verify(2) and not jx.verify(2)
    assert mgr.latest_good() == jx.latest_good() == 1
    back = mgr.load(1, port_tree(0))
    assert resilience.tree_sha256(back) == resilience.tree_sha256(
        port_tree(1))


def test_missing_or_unreadable_manifest_unverified(tmp_path):
    mgr, jx = CheckpointManager(str(tmp_path)), JManager(str(tmp_path))
    mgr.save(3, port_tree(3))
    os.unlink(mgr.path_of(3) + ".manifest.json")
    assert not mgr.verify(3) and not jx.verify(3)
    assert mgr.latest_good() is None and jx.latest_good() is None
    jx.save(5, jax_tree(5))
    with open(mgr.path_of(5) + ".manifest.json", "w") as f:
        f.write("{not json")
    assert not mgr.verify(5) and not jx.verify(5)


def test_retention_and_latest_good(tmp_path):
    """retain=2 keeps the newest two snapshots, their sidecars with them,
    as the JAX manager does in its own directory."""
    dirs = {"port": str(tmp_path / "p"), "jax": str(tmp_path / "j")}
    port = CheckpointManager(dirs["port"], retain=2)
    jx = JManager(dirs["jax"], retain=2)
    for step in (2, 4, 6, 8):
        port.save(step, port_tree(step), metadata={"round": step})
        jx.save(step, jax_tree(step), metadata={"round": step})
    assert port.steps() == jx.steps() == [6, 8]
    assert sorted(os.listdir(dirs["port"])) == sorted(
        os.listdir(dirs["jax"]))
    assert port.latest_good() == 8
    with pytest.raises(ValueError, match="retain"):
        CheckpointManager(dirs["port"], retain=0)


def test_harness_commands():
    cmd = harness.train_cmd(["--device", "cpu", "--k", 2])
    assert cmd[1:4] == ["-m", "repro_torch.launch.train", "--device"]
    assert cmd[-1] == "2"
    env = harness.train_env()
    assert env["PYTHONPATH"].split(os.pathsep)[0].endswith("src")
