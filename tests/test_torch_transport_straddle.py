"""The transport flip rule's straddle test (``check.TransportSteps.explain``)
on constructed sends: a 120-entry leaf (the size of a layer's norm-scale
band in the streaming grid, where one flip alone breaks a bf16 share of
5e-3) with one entry outside the tolerance from a straddle (the two
runs' pre-rounding values on either side of one bf16 boundary, 3.6e-7
apart) and one from a flip of two codes, or of one code with values
further apart than the float32 bound; and the codes the rule compares
against the transport's own rounding (bf16) and the int4 quantizer."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import check
from repro_torch.configs.base import DiLoCoConfig
from repro_torch.kernels import ref

N = 120
PATH = "base.global_params.scale"


def _steps(dtype="bfloat16"):
    params = {"scale": torch.ones(N)}
    dcfg = DiLoCoConfig(k=2, H=1, streaming_fragments=1,
                        outer_grad_dtype=dtype)
    return check.TransportSteps(params, dcfg)


def _send(steps, x, ref_mag=1.0):
    """One send of leaf 0's whole window, the step of its codes kept."""
    x = np.asarray(x, np.float32)[None]
    steps.sends.append({"leaf": 0, "a": 0, "x": x,
                        "ref": np.full(N, ref_mag), "atol": 1e-5})
    np.maximum(steps.step[0][:1], steps._code_steps(x),
               out=steps.step[0][:1])


def _values():
    """This run's pre-rounding values and the other run's: entry 9 a
    straddle (−0.0025864840 in one run, 3.6e-7 away in the other, on
    either side of the bf16 boundary −0.0025863647), entry 50 a flip of
    two bf16 steps (values 3.2e-5 apart, two boundaries between them)."""
    rng = np.random.default_rng(0)
    mine = (rng.standard_normal(N) * 1e-2).astype(np.float32)
    theirs = mine.copy()
    mine[9], theirs[9] = np.float32(-0.0025864840), \
        np.float32(-0.0025861240)
    mine[50], theirs[50] = np.float32(0.0030), np.float32(0.0030320)
    return mine, theirs


def _state(steps, mine, theirs):
    """(got, want) of the leaf: each run's bf16 sent value, as a state
    leaf would carry it."""
    q = lambda x: torch.from_numpy(x).bfloat16().float().numpy()
    return q(mine), q(theirs)


@pytest.mark.parametrize("with_flip", [False, True])
def test_straddle_counted_apart(with_flip):
    steps = _steps()
    mine, theirs = _values()
    if not with_flip:
        mine[50] = theirs[50]
    _send(steps, mine)
    steps.explain([theirs])
    codes = np.abs(steps._codes(mine[None]) - steps._codes(theirs[None]))
    assert codes[0, 9] == 1 and codes[0, 50] == (2 if with_flip else 0)
    got, want = _state(steps, mine, theirs)
    tol = 1e-5 + 1e-4 * np.abs(want)
    outside = ~(np.abs(got - want) <= tol)
    assert outside[9] and outside[50] == with_flip
    share = check._share_outside(PATH, got, want, tol, steps)
    # the straddle is explained and counted apart; the flip counts
    assert steps.explained[PATH] == 1
    assert share == pytest.approx((1 if with_flip else 0) / N)
    assert (share > check.TRANSPORT_FLIP_SHARE["bfloat16"]) == with_flip
    assert [u[2] for u in steps.unexplained] == ([50] if with_flip else [])


def test_without_the_other_run_every_entry_outside_counts():
    """Before ``explain`` the rule is the share alone (one flip of 120
    breaks the bf16 limit)."""
    steps = _steps()
    mine, theirs = _values()
    mine[50] = theirs[50]
    _send(steps, mine)
    got, want = _state(steps, mine, theirs)
    tol = 1e-5 + 1e-4 * np.abs(want)
    assert check._share_outside(PATH, got, want, tol, steps) == \
        pytest.approx(1 / N)
    assert steps.explained == {}


def test_a_straddle_beyond_the_float32_bound_is_a_flip():
    """Codes one apart, but the values further apart than atol + rtol ·
    |operand param| (1.2e-5 against 1e-5 + 1e-8): not explained."""
    steps = _steps()
    mine, theirs = _values()
    mine[50] = theirs[50]
    b = np.float32(-0.0025863647)          # a bf16 rounding boundary
    mine[9], theirs[9] = b - np.float32(6e-6), b + np.float32(6e-6)
    _send(steps, mine, ref_mag=1e-4)
    steps.explain([theirs])
    assert np.abs(steps._codes(mine[None]) - steps._codes(theirs[None])
                  )[0, 9] == 1
    got, want = _state(steps, mine, theirs)
    tol = 1e-5 + 1e-4 * np.abs(want)
    assert check._share_outside(PATH, got, want, tol, steps) == \
        pytest.approx(1 / N)
    assert steps.explained[PATH] == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "int4"])
def test_codes_are_the_transports(dtype):
    """Two values lie on either side of one code boundary exactly when
    their codes differ by one: bf16 codes order the bf16 roundings (ties
    to even), int4 codes are the quantizer's."""
    steps = _steps(dtype)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 300)) * 10.0 ** rng.integers(
        -6, 2, (2, 300))).astype(np.float32)
    codes = steps._codes(x)
    if dtype == "bfloat16":
        # the bf16 rounding's bits, sign and magnitude, as a signed rank
        bits = torch.from_numpy(x).bfloat16().view(torch.int16).numpy()
        mag = bits.astype(np.int64) & 0x7FFF
        np.testing.assert_array_equal(codes, np.where(bits < 0, -mag, mag))
        b = torch.from_numpy(x).bfloat16().float().numpy().reshape(-1)
        order = np.argsort(codes.reshape(-1), kind="stable")
        assert np.all(np.diff(b[order]) >= 0)
    else:
        blk = ref.QUANT_BLOCK
        pad = np.zeros((2, 384), np.float32)
        pad[:, :300] = x
        want, _ = ref.quantize_int4(torch.from_numpy(pad.reshape(-1, blk)))
        want = want.numpy().reshape(2, -1)[:, :300]
        np.testing.assert_array_equal(codes, want)


def test_packed_sharded_sends_recorded_by_rank():
    """The packed sharded transport's sends (``pod_collectives.
    encode_wire``, a region at a time, int4 blocks from the region on) are
    recorded on each pod rank (``pod_rounds.rounds(..., record_sends)``)
    and held rank by rank (``TransportSteps.of_ranks``): two runs of the
    same rounds on CPU ranks record the same sends, explain no flip, and
    their states agree."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh
    from repro_torch.models.registry import get_smoke_arch

    pods, h, b, s = 2, 2, 2, 32
    arch = get_smoke_arch("diloco_150m")
    gen = torch.Generator().manual_seed(0)
    params = arch.init(generator=gen, device="cpu")
    toks = torch.randint(0, arch.cfg.vocab_size, (1, pods, h * b, s),
                         generator=gen)
    dcfg = DiLoCoConfig(k=pods, H=h, streaming_fragments=2, stream_tau=1,
                        stream_alpha=0.5, outer_grad_dtype="int4",
                        error_feedback=True, transport="sharded")
    tcfg = TrainConfig(inner_lr=1e-3, warmup_steps=2, total_steps=4,
                       batch_size=b, seq_len=s)
    ones = np.ones(pods, np.float32)
    runs = [mesh.spawn("repro_torch.launch.pod_rounds:rounds",
                       mesh.make_pod_layout(pods, "cpu"), arch.cfg, dcfg,
                       tcfg, toks, [(ones, ones, ones / pods)], params,
                       None, None, True) for _ in range(2)]
    sends = [[r["sends"] for r in run] for run in runs]
    assert all(len(x["sends"]) > 0 for x in sends[0])
    for x in sends[0]:
        for send in x["sends"]:
            got = np.asarray(send["x"])
            assert got.shape[0] == 1          # the rank's one replica
            assert np.isfinite(got).all() and send["leaf"] is not None
    steps = check.TransportSteps.of_ranks(params, dcfg, sends[1], sends[0])
    shares = check.stream_mismatch_shares(
        runs[0][0]["state"], runs[1][0]["state"], H=h, steps=steps)
    assert max(shares.values()) == 0.0
    assert steps.unexplained == [] and not any(steps.explained.values())
    assert max(float(st.max()) for st in steps.step) > 0
