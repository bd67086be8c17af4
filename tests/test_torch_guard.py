"""The port's anomaly guard against the JAX package's: the host-side
``AnomalyGuard`` on the same loss sequences (verdicts and the events it
records), and ``outer_step`` with a NaN ``bomb_mask``, guarded and
unguarded, on the same state (as ``tests/test_resilience_guard.py``
holds the JAX package).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import DiLoCoConfig as JDCfg  # noqa: E402
from repro.core import diloco as JD  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.resilience import AnomalyGuard as JGuard  # noqa: E402
from repro.resilience import GuardConfig as JGuardConfig  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs.base import DiLoCoConfig, TrainConfig  # noqa: E402
from repro_torch.core import diloco as TD  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.resilience import AnomalyGuard, GuardConfig  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5     # tests/test_torch_diloco.py's outer tolerance
NAN = float("nan")
SEQUENCES = {
    "nan_and_inf": [5.0, 4.9, NAN, 4.8, float("inf"), 4.7],
    "spike": [3.0, 3.1, 2.9, 3.05, 3.0, 9.0, 3.0, 2.95],
    "flat": [2.0] * 6 + [2.0 + 1e-4, 2.5],
    "cold_start": [100.0, 100.1, 100.2, 100.3, 100.9, 100.2],
    "random": list(np.random.default_rng(4).normal(4.0, 0.05, 30)) + [6.0],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_anomaly_guard_matches_jax(name):
    """The same losses, fed chunk by chunk, give the same verdicts, the
    same rollback budget and the same recorded guard events."""
    losses = SEQUENCES[name]
    silent = lambda *a, **kw: None
    recs = (jmetrics.RunRecorder(printer=silent),
            tmetrics.RunRecorder(printer=silent))
    guards = (JGuard(JGuardConfig(window=4, spike=3.0, max_rollbacks=1),
                     recorder=recs[0]),
              AnomalyGuard(GuardConfig(window=4, spike=3.0,
                                       max_rollbacks=1), recorder=recs[1]))
    out = []
    for g in guards:
        bad = []
        for start in range(0, len(losses), 3):
            bad += g.observe_chunk(start, losses[start:start + 3])
            if bad and g.can_rollback():
                g.rolled_back(to_round=start, skip_round=bad[0]["round"])
        out.append((bad, g.verdicts, g.rollbacks_used, g.stats()))
    assert repr(out[1]) == repr(out[0])
    assert repr(recs[1].event_records()) == repr(recs[0].event_records())
    assert recs[1].event_records(), "every sequence trips the guard"


def test_guard_config_validation():
    for kw, match in (({"window": 0}, "window"), ({"spike": 0.0}, "spike"),
                      ({"min_history": 0}, "min_history"),
                      ({"max_rollbacks": -1}, "max_rollbacks")):
        with pytest.raises(ValueError, match=match):
            GuardConfig(**kw)
    assert math.isnan(AnomalyGuard().stats()[0])


def _drifted_state(k=2):
    """A JAX state of the smoke config whose replicas drifted from the
    global copy by seeded noise (numpy leaves)."""
    params, _ = jreg.get_smoke_arch("diloco_150m").init(
        jax.random.PRNGKey(0))
    st = JD.init_state(params, JDCfg(k=k))
    rng = np.random.default_rng(1)
    rep = jax.tree.map(lambda r: r + jnp.asarray(
        rng.standard_normal(r.shape) * 1e-2, r.dtype), st.replica_params)
    return jax.tree.map(np.asarray, st._replace(replica_params=rep))


@pytest.mark.parametrize("guarded", [False, True])
def test_outer_step_bomb_matches_jax(guarded):
    """Replica 1's delta poisoned to NaN: unguarded, the global copy is
    NaN everywhere in both packages; guarded, replica 1 is left out of the
    reduce (guard_rejected = 1) and every leaf of the state matches JAX's
    within the outer tolerance, finite."""
    jstate = _drifted_state()
    bomb = np.array([0.0, 1.0], np.float32)
    jd = JDCfg(k=2, guard_outer=guarded)
    want, jm = jax.jit(lambda s: JD.outer_step(
        s, jd, bomb_mask=jnp.asarray(bomb)))(
        jax.tree.map(jnp.asarray, jstate))
    got, tm = TD.outer_step(convert.state_from_numpy(jstate, device="cpu"),
                            DiLoCoConfig(k=2, guard_outer=guarded),
                            bomb_mask=bomb)
    pairs = list(zip(tree.paths(convert.params_to_numpy(got.global_params)),
                     tree.paths(jax.tree.map(np.asarray,
                                             want.global_params))))
    if not guarded:
        assert "guard_rejected" not in tm
        for (path, a), (_, b) in pairs:
            assert np.isnan(a).all() and np.isnan(b).all(), path
        return
    assert float(tm["guard_rejected"]) == float(jm["guard_rejected"]) == 1.0
    for (path, a), (_, b) in pairs:
        assert np.isfinite(a).all(), path
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=path)
    # the bombed replica adopts the new global, as in JAX
    for (path, a), (_, b) in zip(
            tree.paths(convert.params_to_numpy(got.replica_params)),
            tree.paths(jax.tree.map(np.asarray, want.replica_params))):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=path)
    np.testing.assert_allclose(float(tm["outer_gnorm"]),
                               float(jm["outer_gnorm"]), rtol=RTOL)


def test_nan_bombs_rejected_off_classic_simulated_transport():
    bombs = np.zeros((2, 2), np.float32)
    tcfg = TrainConfig()
    for dcfg in (DiLoCoConfig(k=2, streaming_fragments=2),
                 dataclasses.replace(DiLoCoConfig(k=2,
                                                  streaming_fragments=2),
                                     transport="sharded")):
        with pytest.raises(ValueError, match="nan_bombs"):
            TD.make_run(lambda p, b: None, None, dcfg, tcfg,
                        rounds_per_call=2, nan_bombs=bombs)
