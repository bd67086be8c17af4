"""``launch/comm_analysis.py`` against the JAX ``launch/hlo_analysis.py``
and against real collectives: ``roofline`` is JAX's formula on the same
inputs and constants, and a ``CountingGroup`` running a sharded round on
meta tensors counts exactly the traffic two gloo ranks' ``PodGroup``s
measure running it (``launch/mesh.spawn``), which is also what
``streaming.sync_plan`` and ``ops.transport_bytes`` charge."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as JH
from repro_torch import tree
from repro_torch.configs.base import DiLoCoConfig, TrainConfig
from repro_torch.core import diloco, streaming
from repro_torch.kernels import ops
from repro_torch.launch import comm_analysis as C
from repro_torch.launch import mesh, op_cost
from repro_torch.models.registry import get_smoke_arch

K, PODS, H, B, S, ROUNDS = 2, 2, 2, 2, 16, 2
TCFG = TrainConfig(inner_lr=3e-3, warmup_steps=1, total_steps=ROUNDS * H,
                   batch_size=B, seq_len=S)
WIRE_KEYS = ("all_reduce", "all_gather", "gather_wire", "exchange",
             "wire_bytes", "metric_bytes")
CASES = {"float32": dict(streaming_fragments=2, outer_grad_dtype="float32"),
         "int4": dict(streaming_fragments=2, outer_grad_dtype="int4",
                      stream_tau=1, stream_alpha=0.5, error_feedback=True)}


def _both(counts: dict):
    jst = JH.CollectiveStats(**counts)
    tst = C.CollectiveStats(**counts)
    return jst, tst


@pytest.mark.parametrize("counts", [
    dict(),
    dict(total_bytes=10 ** 11, intra_pod_bytes=10 ** 11,
         by_op={"all-reduce": 10 ** 11}),
    dict(total_bytes=3 * 10 ** 9, cross_pod_bytes=2 * 10 ** 9,
         intra_pod_bytes=10 ** 9,
         by_op={"all-reduce": 2 * 10 ** 9, "all-gather": 10 ** 9}),
    dict(total_bytes=7 * 10 ** 8, cross_pod_bytes=7 * 10 ** 8,
         by_op={"collective-permute": 7 * 10 ** 8})])
def test_roofline_is_jax_formula(counts):
    jst, tst = _both(counts)
    assert tst.as_dict() == jst.as_dict()
    for flops, nbytes in ((1e18, 1e12), (1e12, 1e9), (3e15, 2e13)):
        kw = dict(chips=256, ici_bw=C.NVLINK_BW, dcn_bw=C.CROSS_ISLAND_BW,
                  peak=C.PEAK_BF16, hbm=C.HBM_BW)
        assert C.roofline(flops, nbytes, tst, **kw) == \
            JH.roofline(flops, nbytes, jst, **kw)
        # the defaults are the H100's, named once
        assert C.roofline(flops, nbytes, tst, chips=256) == \
            C.roofline(flops, nbytes, tst, **kw)


def test_constants_are_the_h100s():
    assert (C.PEAK_BF16, C.PEAK_TF32, C.PEAK_F32, C.HBM_BW) == \
        (989.4e12, 494.7e12, 66.9e12, 3.35e12)
    assert C.NVLINK_BW == 450e9 and C.CROSS_ISLAND_BW == 400e9 / 8
    assert C.memory_budget() == {"bytes": 80 * 10 ** 9,
                                 "source": C.CARD + " (data sheet)"}
    v5e = {JH.PEAK_FLOPS, JH.HBM_BW, JH.DCN_BW, 16e9}
    assert not v5e & {C.PEAK_BF16, C.PEAK_TF32, C.PEAK_F32, C.HBM_BW,
                      C.HBM_BYTES, C.NVLINK_BW}


def test_counting_group_returns_shapes_without_data():
    g = C.CountingGroup(1, 4)
    x = torch.empty((2, 3), device="meta")
    assert g.all_gather(x).wait().shape == (8, 3)
    assert g.all_reduce(x) is x
    assert g.exchange(x, 0).shape == x.shape
    assert g.exchange(x, 1) is x                  # sitting out: no call
    assert g.decide(7) == 7 and g.agree(b"anything")
    g.barrier()
    assert g.traffic["all_gather"] == g.traffic["all_reduce"] == 1
    assert g.traffic["exchange"] == 1 and g.traffic["control"] == 3
    assert g.traffic["wire_bytes"] == 3 * 24
    assert g.traffic["control_bytes"] == 8 + 32  # decide; agree's digest
    assert g.stats.by_op == {"all-gather": 24 + 32, "all-reduce": 24,
                             "collective-permute": 24,
                             "collective-broadcast": 8}
    assert g.events == ["sync", "sync", "sync"]


def test_memory_items():
    cost = {"peak_live_bytes": 1600, "end_live_bytes": 160}
    got = C.memory_items(1000, cost, batch_shards=16)
    assert (got["argument_size_in_bytes"], got["temp_size_in_bytes"],
            got["output_size_in_bytes"], got["peak_bytes_est"]) == \
        (1000, 100, 10, 1100)
    assert got["fits"] and got["budget_bytes"] == 80 * 10 ** 9


def _tokens():
    gen = torch.Generator().manual_seed(3)
    return [torch.randint(0, get_smoke_arch("diloco_60m").cfg.vocab_size,
                          (K, H * B, S), generator=gen)
            for _ in range(ROUNDS)]


def _counted(dcfg):
    """rank 0's traffic of ROUNDS sharded rounds, counted on meta."""
    arch = get_smoke_arch("diloco_60m")
    group = C.CountingGroup(0, PODS)
    rnd = diloco.make_round(
        lambda p, b: arch.loss(p, b),
        lambda gen, n, s: torch.zeros((K, n, s), dtype=torch.int64,
                                      device="meta"),
        dcfg, TCFG, batch_size=B, seq_len=S, group=group)
    with op_cost.counting():
        state = streaming.init_state(
            arch.init(generator=None, device="meta"), dcfg, group=group)
        for _ in range(ROUNDS):
            state, _ = rnd(state, None)
    return group


@pytest.mark.parametrize("wire", sorted(CASES))
def test_counted_traffic_equals_gloo_ranks(wire):
    dcfg = DiLoCoConfig(k=K, H=H, transport="sharded", **CASES[wire])
    arch = get_smoke_arch("diloco_60m")
    params = arch.init(generator=torch.Generator().manual_seed(0),
                       device="cpu")
    ones = np.ones((K,), np.float32)
    ranks = mesh.spawn("repro_torch.launch.pod_rounds:rounds",
                       mesh.make_pod_layout(PODS, "cpu"), arch.cfg, dcfg,
                       TCFG, _tokens(), [(ones, ones, ones)] * ROUNDS,
                       params)
    group = _counted(dcfg)
    counted = {n: group.traffic[n] for n in WIRE_KEYS}
    for r in ranks:
        assert {n: r["traffic"][n] for n in WIRE_KEYS} == counted
    plan = streaming.sync_plan(params, dcfg)
    per_round = sum(p["wire_bytes"] for p in plan)
    assert counted["wire_bytes"] == (K // PODS) * ROUNDS * per_round
    assert counted["gather_wire"] == ROUNDS * len(plan) * (wire != "float32")
    if wire == "int4":
        part, regions = streaming._partition(params, dcfg)
        assert per_round == sum(ops.transport_bytes(r.elems, "int4",
                                                    packed=True)
                                for regs in regions for r in regs)
    else:
        assert per_round == 4 * sum(t.numel() for t in tree.leaves(params))
    # the rank's bytes as CollectiveStats: all of them cross pods
    assert group.stats.cross_pod_bytes == group.stats.total_bytes == \
        counted["wire_bytes"] + counted["metric_bytes"]
    assert dataclasses.asdict(group.stats)["intra_pod_bytes"] == 0
