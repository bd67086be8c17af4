"""The xLSTM family (``xlstm_350m``: mLSTM and sLSTM blocks, no
positions) against the JAX package at smoke width: ``mlstm_cell`` and
``slstm_cell`` from a carried state, ``apply_mlstm`` / ``apply_slstm``
over time, loss and gradients, prefill and decode (the (C, n, m) and
(c, n, h, m) states as tuples in the cache), one k=2, H=2 DiLoCo round;
then the port's engines: paged = contiguous = each request alone, bit
for bit, and an admission resets a reused slot's states to their empty
values, the stabilisers m to −1e30 (JAX's paged engine blanks them to 0,
which its own ``test_paged_bit_identical_to_contiguous[xlstm_350m-0]``
catches; the port is held to JAX's contiguous engine and to the request
alone).

Tolerances: f32, atol 1e-5, rtol 1e-4 (gradients atol 1e-6, rtol 1e-4);
tokens exactly."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import families_common as FC  # noqa: E402
from repro.launch.batching import ContinuousBatcher as JBatcher  # noqa: E402
from repro.models import xlstm as JX  # noqa: E402
from repro_torch.launch.batching import ContinuousBatcher  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402

torch.set_num_threads(2)
NAME = "xlstm_350m"


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_mlstm_cell_matches_jax():
    rng = np.random.default_rng(0)
    B, H, d = 2, 4, 8
    carry = (_rand(rng, B, H, d, d), _rand(rng, B, H, d) ** 2,
             _rand(rng, B, H))
    inp = (_rand(rng, B, H, d), _rand(rng, B, H, d), _rand(rng, B, H, d),
           _rand(rng, B, H), _rand(rng, B, H))
    for c in (carry, tuple(np.array(a) for a in JX.init_mlstm_state(
            FC.archs(NAME)[0].cfg.replace(d_model=H * d, n_heads=H), B))):
        (jC, jn, jm), jh = JX.mlstm_cell(tuple(map(jnp.asarray, c)),
                                         tuple(map(jnp.asarray, inp)))
        (tC, tn, tm), th = TX.mlstm_cell(tuple(map(torch.from_numpy, c)),
                                         tuple(map(torch.from_numpy, inp)))
        for got, want, what in ((tC, jC, "C"), (tn, jn, "n"), (tm, jm, "m"),
                                (th, jh, "h")):
            FC.close(got, want, what)


def test_slstm_cell_matches_jax():
    ja, _, jp, tp = FC.archs(NAME)
    cfg = ja.cfg
    rng = np.random.default_rng(1)
    B, H = 2, cfg.n_heads
    dh = cfg.d_model // H
    carry = (_rand(rng, B, H, dh), _rand(rng, B, H, dh) ** 2,
             _rand(rng, B, H * dh), _rand(rng, B, H, dh))
    xt = {g: _rand(rng, B, cfg.d_model) for g in "zifo"}
    jr = {k: jp["stack1"]["cell"][k][0] for k in ("rz", "ri", "rf", "ro")}
    tr = {k: tp["stack1"]["cell"][k][0] for k in ("rz", "ri", "rf", "ro")}
    jc, jh = JX.slstm_cell(jr, cfg, tuple(map(jnp.asarray, carry)),
                           {k: jnp.asarray(v) for k, v in xt.items()})
    tc, th = TX.slstm_cell(tr, cfg, tuple(map(torch.from_numpy, carry)),
                           {k: torch.from_numpy(v) for k, v in xt.items()})
    FC.close(th, jh, "h")
    FC.assert_tree_close(tc, jc, what="carry")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_apply_cells_over_time_match_jax(kind):
    ja, _, jp, tp = FC.archs(NAME)
    i = 0 if kind == "mlstm" else 1
    jc = {k: v[0] for k, v in jp[f"stack{i}"]["cell"].items()}
    tc = {k: v[0] for k, v in tp[f"stack{i}"]["cell"].items()}
    x = _rand(np.random.default_rng(2), 2, 9, ja.cfg.d_model)
    jfn = JX.apply_mlstm if kind == "mlstm" else JX.apply_slstm
    tfn = TX.apply_mlstm if kind == "mlstm" else TX.apply_slstm
    jo, js = jfn(jc, jnp.asarray(x), ja.cfg)
    to, ts = tfn(tc, torch.from_numpy(x), ja.cfg)
    FC.close(to, jo, "out")
    FC.assert_tree_close(ts, js, what="state")


def test_loss_and_grads_match_jax():
    FC.check_loss_and_grads(NAME)


def test_prefill_and_decode_match_jax():
    FC.check_prefill_decode(NAME)


def test_round_matches_jax():
    FC.check_round(NAME)


def _requests():
    rng = np.random.default_rng(5)
    lengths, gens = [12, 7, 19, 5, 9], [6, 1, 4, 8, 5]
    return [rng.integers(0, 256, n) for n in lengths], gens


def test_paged_equals_contiguous_and_alone():
    FC.check_paged_equals_contiguous(NAME)


def test_engines_equal_jax_contiguous_engine():
    """The port's paged and contiguous engines against the JAX contiguous
    engine (whose admission blanks a row from its init_cache)."""
    ja, _, jp, _ = FC.archs(NAME)
    prompts, gens = _requests()
    outs, _ = FC.serve_engines(NAME, prompts, gens)
    jeng = JBatcher(ja, jp, slots=2, cache_len=64, paged=False)
    rids = [jeng.submit(p, g) for p, g in zip(prompts, gens)]
    done = jeng.run_until_drained()
    for r, a, b in zip(rids, outs[True], outs[False]):
        np.testing.assert_array_equal(a, done[r])
        np.testing.assert_array_equal(b, done[r])


# the stabilisers of the smoke config's mLSTM (cache0) and sLSTM (cache1)
M_PATHS = {("cache0", "state", "2"), ("cache1", "state", "3")}


@pytest.mark.parametrize("paged", [True, False])
def test_admission_resets_the_stabilisers(paged):
    """After a request has run in slot 0, admitting the next one resets
    every per-slot leaf of that slot to ``init_block_cache``'s value:
    the mLSTM's and sLSTM's m to −1e30, everything else to 0."""
    _, ta, _, tp = FC.archs(NAME)
    eng = ContinuousBatcher(ta, tp, slots=1, cache_len=32, paged=paged)
    eng.submit(np.arange(6), 4)
    eng.run_until_drained()
    before = FC.flat(eng.cache)
    assert all(np.all(before[p] > -1e29) for p in M_PATHS)
    row = FC.flat(eng._slot_row(0))
    assert M_PATHS <= set(row)
    for path, a in row.items():
        want = -1e30 if path in M_PATHS else 0
        np.testing.assert_array_equal(a, np.full_like(a, want),
                                      err_msg=str(path))
