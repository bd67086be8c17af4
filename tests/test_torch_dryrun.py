"""The port's dry run (``launch/dryrun.py``) against the JAX one: its mini
dry run (diloco_60m ``train_4k`` on (2, 2) and (2, 2, 2), two
microbatches, ``main,stream,gossip``, plus ``decode_32k``) reproduced on
meta tensors with the JAX test's structural assertions; the parameter
and model-FLOP counts; the manifest; the refusals; the pod-sharded
butterfly exchange (``PodGroup.exchange``) on 2 and 4 gloo ranks against
``gossip.mix_round``; and the SSM family at the dry run's bf16 compute
dtype against JAX."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.models import registry as JR
from repro_torch import convert, tree
from repro_torch.configs import base as TB
from repro_torch.core import gossip
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh
from repro_torch.models import registry as TR
from repro_torch.sharding.spec import MeshShape

import dryrun_common
import families_common as FC

SINGLE = MeshShape(("data", "model"), (2, 2))
MULTI = MeshShape(("pod", "data", "model"), (2, 2, 2))


@pytest.fixture(scope="module")
def jax_dryrun():
    return dryrun_common.import_jax_dryrun()


@pytest.fixture(scope="module")
def mini():
    out = []
    for m, mp, fns in [(SINGLE, False, ("main",)),
                       (MULTI, True, ("main", "stream", "gossip"))]:
        out += TD.dryrun_pair("diloco_60m", "train_4k", multi_pod=mp,
                              microbatches=2, mesh=m, fns=fns)
    out += TD.dryrun_pair("diloco_60m", "decode_32k", multi_pod=False,
                          mesh=SINGLE)
    return out


def test_mini_dryrun_structure(mini):
    assert {r["fn"] for r in mini} == {
        "inner_train_step", "diloco_inner_step", "diloco_outer_step",
        "ddp_train_step", "diloco_stream_round", "gossip_exchange",
        "serve_step"}
    for r in mini:
        assert "error" not in r, r
        c = r["collectives"]
        # within the island: the FSDP×TP steps' collectives counted on the
        # island mesh's DTensors; none in the elementwise outer update and
        # exchange; the streaming round's inner steps counted unsharded
        if r["fn"] == "diloco_stream_round":
            assert c["intra_pod_bytes"] is None and "not modelled" in \
                c["intra_pod"]
            assert r["roofline"]["collective_intra_s"] is None
        elif r["fn"] in ("diloco_outer_step", "gossip_exchange"):
            assert c["intra_pod_bytes"] == 0
            assert r["roofline"]["collective_intra_s"] == 0
        else:
            assert isinstance(c["intra_pod_bytes"], int) and \
                c["intra_pod_bytes"] > 0
            assert r["roofline"]["collective_intra_s"] > 0
        assert r["memory"]["peak_bytes_est"] > 0
        if r["fn"] in ("inner_train_step", "diloco_inner_step",
                       "ddp_train_step"):
            # the AdamW step: one fused leaf per parameter leaf
            assert r["fused_leaves_per_island"] == {"fused_adamw": 12}
        if r["fn"] in ("inner_train_step", "serve_step",
                       "diloco_inner_step"):
            # the paper's core property: an inner step talks to no pod
            assert c["cross_pod_bytes"] == 0 and c["cross_count_by_op"] == {}
        if r["fn"] in ("diloco_outer_step", "ddp_train_step"):
            assert c["cross_pod_bytes"] > 0
            assert set(c["cross_by_op"]) == {"all-reduce"}
        if r["fn"] == "diloco_stream_round":
            P = TD.STREAM_FRAGMENTS
            st = r["stream_interleaving"]
            assert st["pod_all_reduces"] >= P, st
            assert st["syncs_with_compute_after"] >= P - 1, st
            assert st["compute_events"] > 0, st
            assert st["syncs_inside_compute"] == 0, st
            assert c["cross_pod_bytes"] > 0
        if r["fn"] == "gossip_exchange":
            assert c["cross_pod_bytes"] > 0
            assert set(c["cross_by_op"]) == {"collective-permute"}, c
    by = {r["fn"]: r for r in mini}
    # DDP all-reduces every step's gradients, DiLoCo's outer step the
    # deltas once: the same tree, the same bytes per sync
    assert by["ddp_train_step"]["collectives"]["cross_pod_bytes"] == \
        by["diloco_outer_step"]["collectives"]["cross_pod_bytes"]
    # the two islands' inner steps do a single island's step's work, plus
    # the second island's AdamW (16 FLOPs an entry)
    n = by["inner_train_step"]["params"]
    assert by["diloco_inner_step"]["flops"] == by["ddp_train_step"][
        "flops"] == by["inner_train_step"]["flops"] + 16 * n


def test_stream_round_overlap():
    """A deferred int4 wire: every gather consumed τ inner steps after
    its issue, as the round's ``OverlapProbe`` measures it."""
    recs = TD.dryrun_pair("diloco_60m", "train_4k", multi_pod=True,
                          microbatches=2, mesh=MULTI, fns=("stream",),
                          stream_wire="int4", stream_tau=1)
    (r,) = recs
    ov, st = r["stream_overlap"], r["stream_interleaving"]
    assert ov["n_deferred"] == TD.STREAM_FRAGMENTS and ov["ok"], ov
    assert ov["min_steps_between"] >= 1
    assert set(st["sync_by_op"]) == {"all-gather", "all-reduce"}
    assert r["collectives"]["per_rank"]["by_op"]["all-gather"] == \
        r["collectives"]["traffic"]["wire_bytes"]


def test_counts_equal_jax(jax_dryrun, mini):
    """(A shape's window changes no parameter: one count an arch.)"""
    for name in JR.ARCH_NAMES:
        jcfg = JR.get_arch(name).cfg
        pad = (-jcfg.vocab_size) % 16
        assert TD.vocab_padding(jcfg.vocab_size, 16) == pad
        jcfg = jcfg.replace(vocab_size=jcfg.vocab_size + pad)
        tcfg = TR.get_arch(name).cfg.replace(vocab_size=jcfg.vocab_size)
        js, jax_axes = JR.Arch(jcfg).abstract_params()
        tp, tax = TR.Arch(tcfg).abstract_params()
        jn = jax_dryrun.count_params(js, jax_axes, jcfg)
        tn = TD.count_params(tp, tax, tcfg)
        assert tn == jn, name
        for shape in JB.SHAPES.values():
            assert TD.model_flops(*tn, TB.SHAPES[shape.name]) == \
                jax_dryrun.model_flops(*jn, shape)
    r = next(x for x in mini if x["fn"] == "inner_train_step")
    tn = TD.count_params(*TR.get_arch("diloco_60m").abstract_params(),
                         TR.get_arch("diloco_60m").cfg)
    assert (r["params"], r["active_params"]) == tn and r["vocab_pad"] == 0
    assert r["model_flops"] == TD.model_flops(*tn, TB.SHAPES["train_4k"])


def test_manifest_equals_jax(jax_dryrun, mini):
    assert TD.manifest_of(mini, config={"arch": "diloco_60m"}) == \
        jax_dryrun.manifest_of(mini, config={"arch": "diloco_60m"})


def test_refusals(capsys):
    for mode in ("kernel", "pallas", "interpret"):
        with pytest.raises(ValueError, match=mode):
            TD.dryrun_pair("diloco_60m", "decode_32k", multi_pod=False,
                           mesh=SINGLE, kernel_mode=mode)
    # every family runs on an island's DTensors and takes the variants
    # that steer within-island collectives
    # (tests/test_torch_dryrun_island.py); an island whose "model" axis
    # cannot cut a model's inner width is refused by the model: xLSTM's
    # 4 heads of 256 on 3 ranks
    with pytest.raises(ValueError, match="xLSTM on an island.*cut 3 ways"):
        TD.dryrun_pair("xlstm_350m", "decode_32k", multi_pod=False,
                       mesh=MeshShape(("data", "model"), (1, 3)))
    with pytest.raises(ValueError, match="unknown variant"):
        TD.dryrun_pair("diloco_60m", "decode_32k", multi_pod=False,
                       mesh=SINGLE, variant={"bogus": True})
    with pytest.raises(SystemExit):
        TD.main(["--arch", "diloco_60m", "--shape", "decode_32k",
                 "--kernel-mode", "pallas"])
    assert "kernel_mode='pallas'" in capsys.readouterr().err


@pytest.mark.parametrize("pods,k", [(4, 4), (2, 4)])
def test_pod_exchange_equals_mix_round(pods, k):
    """``PodGroup.exchange`` pairs each rank with its butterfly partner's
    rank (or keeps a stage inside the band): every band of the result is
    ``mix_round``'s on the stacked estimates, bit for bit."""
    rng = np.random.default_rng(k + pods)
    est = {"a": rng.standard_normal((k, 5, 3)).astype(np.float32),
           "b": {"c": rng.standard_normal((k, 7)).astype(np.float32)}}
    stages = range(k.bit_length() - 1)
    want = {s: convert.params_to_numpy(gossip.mix_round(
        convert.params_from_numpy(est, device="cpu"),
        gossip.partner_map(k, s, "butterfly"),
        tree.map(lambda _: 1.0, est), mix=0.5)) for s in stages}
    ranks = mesh.spawn("repro_torch.launch.pod_rounds:gossip_exchanges",
                       mesh.make_pod_layout(pods, "cpu"),
                       convert.params_from_numpy(est, device="cpu"),
                       list(stages), 0.5)
    k_loc = k // pods
    for r, by_stage in enumerate(ranks):
        for s, (band, exchanges) in zip(stages, by_stage):
            for path, got in tree.paths(band):
                full = dict(tree.paths(want[s]))[path]
                np.testing.assert_array_equal(
                    got, full[r * k_loc:(r + 1) * k_loc])
            # one exchange a leaf with the partner band's rank, none for a
            # stage inside the band
            assert exchanges == (2 if (1 << s) >= k_loc else 0)


def test_ssm_runs_at_bf16_compute_as_jax():
    """zamba2 at the dry run's compute dtype, with the family tests'
    perturbed parameters: the SSD scan's bf16 B and C meet its float32
    states (the port raised on the mixed einsums of the chunked scan and
    of the decode step). The loss, the prefill logits and a decode step's
    logits follow JAX's at bf16 compute: the loss to rtol 1e-3, the
    logits within 3e-2 of max|logit| (measured 1.1 %). The Mamba2 branch
    moves the decode logits by more than ten times that tolerance, so the
    comparison sees what the scan computes."""
    ja, ta, jp, tp = FC.archs("zamba2_2_7b", compute_dtype="bfloat16")
    b = FC.batch_np(ja.cfg, b=2, s=64)
    jl = jax.jit(lambda p, x: ja.loss(p, x)[0])(jp, FC.to_jax(b))
    with torch.no_grad():
        tl = ta.loss(tp, FC.to_torch(b))[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    nxt = b["tokens"][:, :1]
    jpre, jc = ja.prefill(jp, FC.to_jax(b), cache_len=65)
    jdec, _ = ja.decode(jp, jc, jnp.asarray(nxt), jnp.asarray(64, jnp.int32))
    as_np = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    jpre, jdec = as_np(jpre), as_np(jdec)
    atol = 3e-2 * np.abs(jdec).max()

    def serve(params):
        with torch.no_grad():
            pre, cache = ta.prefill(params, FC.to_torch(b), cache_len=65)
            dec = ta.decode(params, cache, torch.from_numpy(nxt).long(),
                            64)[0]
        return pre.float().numpy(), dec.float().numpy()

    tpre, tdec = serve(tp)
    np.testing.assert_allclose(tpre, jpre, rtol=0,
                               atol=3e-2 * np.abs(jpre).max())
    np.testing.assert_allclose(tdec, jdec, rtol=0, atol=atol)
    no_ssm = tree.map(lambda t: t, tp)
    for name in ("stack0", "stack1"):
        no_ssm[name]["mixer"]["out_proj"] = torch.zeros_like(
            tp[name]["mixer"]["out_proj"])
    assert np.abs(serve(no_ssm)[1] - tdec).max() > 10 * atol


def test_cli_writes_records_and_manifest(tmp_path):
    out, man = tmp_path / "r.json", tmp_path / "m.json"
    assert TD.main(["--arch", "diloco_60m", "--shape", "long_500k",
                    "--out", str(out), "--manifest", str(man)]) == 0
    (rec,) = json.loads(out.read_text())
    assert rec["fn"] == "serve_step" and rec["mesh"] == "16x16"
    assert rec["chips"] == 256 and rec["memory"]["fits"]
    assert json.loads(man.read_text())["hlo_profile"] == {
        "diloco_60m/long_500k/serve_step": {
            "arch": "diloco_60m", "shape": "long_500k", "mesh": "16x16",
            "chips": 256, "collectives": rec["collectives"]}}


def test_extrapolation_fits_a_checked_quadratic():
    """A per-token loop's counts come from four short lengths: a count
    that is a quadratic in the length is extrapolated exactly; a count
    that changes regime among the first lengths is fitted from the first
    window of four lengths past the change (the window moves on by one
    step at a time, at most ``FIT_SHIFTS`` times); any other count is
    refused (no silent trip multiplier)."""
    quad = lambda s: 7 * s * s + 3 * s + 11
    got = TD._extrapolated(lambda s: dict.fromkeys(TD._COUNTS, quad(s)),
                           32768, 32)
    assert got["extrapolated_from"] == [32, 64, 96, 128]
    assert all(got[k] == quad(32768) for k in TD._COUNTS)
    # affine from 90 on: the third window is the first past the change
    got = TD._extrapolated(lambda s: dict.fromkeys(TD._COUNTS, max(s, 90)),
                           4096, 4 * 8)
    assert got["extrapolated_from"] == [96, 128, 160, 192]
    assert all(got[k] == 4096 for k in TD._COUNTS)
    with pytest.raises(ValueError, match="not a quadratic"):
        TD._extrapolated(lambda s: dict.fromkeys(TD._COUNTS, s ** 3),
                         4096, 4 * 8)
