"""The dry run's island counts of the xLSTM family (``models/xlstm.py`` on
an island mesh of DTensors with meta blocks, on a ``fake`` process
group), all on meta tensors, and the ``pure_dp`` decode of every
attention family on an island.

- ``pure_dp`` ``decode_32k`` on (data 2, model 2): the batch lies over
  both axes, the cache over "data" alone (``cache_pspec``); the queries
  go to the cache's layout (an all-to-all a layer) and the record has
  integer ``intra_pod_bytes``. One config per attention family, and
  xlstm_350m, whose cells bring their state to the batch's layout.
- The global FLOPs of an xLSTM island step against the unsharded count:
  equal where "model" divides the heads (xlstm_350m ``train_4k`` at full
  width, one group, on (2, 2)); where a head is cut over several model
  ranks (the smoke config), more by a closed form (each rank's backward
  through the per-head work runs on its own columns' partial gradient).
- A closed form of the sLSTM's pre-activation gathers and the cells'
  sums of squares at (2, 2).
- No collective inside the per-token loop: a step at 8 and at 16 tokens
  issues the same collectives, and the per-token fit refuses counts
  whose collectives grow with the length.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as TD
from repro_torch.launch import op_cost
from repro_torch.models.registry import get_smoke_arch
from repro_torch.sharding.spec import MeshShape

SQUARE = MeshShape(("data", "model"), (2, 2))
B, S = 4, 16


def _smoke(**change):
    return get_smoke_arch("xlstm_350m").cfg.replace(
        compute_dtype="bfloat16", remat=False, **change)


def _unsharded_flops(cfg, batch, seq):
    """The FLOPs of the same step on plain meta tensors (one microbatch)."""
    arch = get_smoke_arch("xlstm_350m")
    p = TD._meta_params(arch, cfg, torch.float32)[0]
    fn = TD.build_train_step(type(arch)(cfg=cfg), cfg, groups=1,
                             microbatches=1)
    inputs = arch.input_specs(ShapeConfig("t", seq, batch, "train"),
                              dtype=torch.bfloat16)
    return TD._count(fn, (p, tree.map(TD._meta_like, p),
                          tree.map(TD._meta_like, p), 0, inputs))["flops"]


@pytest.mark.parametrize("arch_name", [
    "diloco_60m", "olmoe_1b_7b", "zamba2_2_7b", "llama_3_2_vision_90b",
    "whisper_large_v3", "xlstm_350m"])
def test_pure_dp_decode_on_island(arch_name):
    """``pure_dp`` puts the batch over ("data", "model") and the cache's
    batch over "data" (``cache_pspec``, as JAX's ``cache_shardings``): the
    decode's attention runs in the cache's layout (the queries, one token
    a row, brought there by an all-to-all; an xLSTM state brought to the
    batch's) instead of broadcasting a (B/2, ...) mask against (B/4, ...)
    scores. The record counts that resharding."""
    (rec,) = TD.dryrun_pair(arch_name, "decode_32k", multi_pod=False,
                            mesh=SQUARE, variant={"pure_dp": True})
    c = rec["collectives"]
    assert isinstance(c["intra_pod_bytes"], int) and \
        c["intra_pod_bytes"] > 0 and "intra_pod" not in c
    assert c["by_op"].get("all-to-all", 0) > 0, c["by_op"]
    assert isinstance(rec["memory"]["fits"], bool)
    assert rec["memory"]["peak_bytes_est"] > 0 and rec["flops"] > 0


def _excess(cfg, model: int, batch: int, seq: int) -> int:
    """The closed form of a sharded xLSTM train step's FLOPs over the
    unsharded count. Where ``rr`` = model / H ranks share a head, each
    runs the head's per-head work (its q, k, i and f projections, n, m,
    |n·q|; the sLSTM's recurrence), counted once per distinct head, but
    its backward from the gradient of its own columns alone: those
    products run rr times, over rr partial gradients that sum to the
    whole. Per mLSTM layer: the four projections' two backward products
    (2·B·T·D·(2·D + 2·H) each) and |n·q|'s two (2·B·T·D); per sLSTM
    layer: the recurrence's two products a gate and token (2·B·D·dh
    each), but the first token's input gradient (its h is the zero
    state)."""
    D, H = cfg.d_model, cfg.n_heads
    rr = max(1, model // H)
    plan = ("mlstm",) * (cfg.slstm_every - 1) + ("slstm",)
    groups = cfg.n_layers // cfg.slstm_every
    m_layer = batch * seq * D * (8 * (D + H) + 4)
    s_layer = batch * D * (D // H) * (16 * seq - 8)
    return (rr - 1) * groups * sum(m_layer if k == "mlstm" else s_layer
                                   for k in plan)


@pytest.mark.parametrize("heads,shape", [(1, (1, 2)), (2, (1, 4))])
def test_xlstm_flops_closed_form(heads, shape):
    """The smoke config's island step (B 4, S 16, one microbatch, remat
    off) where "model" does not divide the heads: its global FLOPs exceed
    the unsharded count by ``_excess`` (where it divides them, each
    rank's heads are whole and the counts are equal:
    ``test_global_flops_equal_unsharded_xlstm``)."""
    cfg = _smoke(n_heads=heads)
    got = TD.island_step_cost(cfg, B, S, shape)["flops"]
    want = _unsharded_flops(cfg, B, S)
    assert got - want == _excess(cfg, shape[1], B, S) > 0
    assert _excess(cfg, heads, B, S) == 0


def test_global_flops_equal_unsharded_xlstm(monkeypatch):
    """``tests/test_torch_dryrun_island.py::test_global_flops_equal_
    unsharded`` on xlstm_350m ``train_4k`` at full width on (2, 2) (each
    rank two whole heads): the sharded FLOPs equal the unsharded count,
    both fitted from four lengths. Its depth is cut to one group (three
    mLSTM blocks and an sLSTM block; the groups are alike) and remat is
    off, so that the fit needs no more than four counts; it runs here,
    beside the other xLSTM counts, so that the island file stays within
    its share of the test run."""
    import test_torch_dryrun_island as DI
    from repro_torch.models import registry
    real = registry.get_arch
    cut = lambda name: registry.Arch(cfg=real(name).cfg.replace(n_layers=4))
    monkeypatch.setattr(TD, "get_arch", cut)
    monkeypatch.setattr(DI, "get_arch", cut)
    DI.test_global_flops_equal_unsharded(
        monkeypatch, "xlstm_350m", "train_4k",
        {"microbatches": 1, "remat": False}, SQUARE)


def test_xlstm_collectives_closed_form(monkeypatch):
    """One head of 128 on (data 2, model 2) (a rank's block of the inner
    width is half the head), the residual stream's d_model not sharded
    (``act_model_shard`` off) and the blocks' norms RMSNorms (so that the
    only activations gathered or reduced at (B/2, T, ·) are the cells'),
    B 4, S 16, one microbatch: per sLSTM layer each of the four
    pre-activations' own columns (2, 16, 64) is all-gathered over "model"
    in bf16, a chip receiving the other half, and its gradient, the
    head's (2, 16, 128), reduce-scattered back (DTensor hands the
    reduce-scatter its two halves stacked, (4, 16, 64)); each cell's
    RMSNorm sums its squares over "model", a (2, 16, 1) float32
    all-reduce a chip sends half of, and its gradient is reduced back so.
    Every such count is per layer and independent of the loop: none is
    issued per token."""
    seen = []
    real = op_cost._collective

    def spy(func, args):
        got = real(func, args)
        if got is not None:
            seen.append((*got, args[0].element_size(),
                         tuple(args[0].shape)))
        return got
    monkeypatch.setattr(op_cost, "_collective", spy)
    cfg = _smoke(n_heads=1, act_model_shard=False, norm="rmsnorm")
    TD.island_step_cost(cfg, B, S, SQUARE.shape)
    Bl, n, D = B // 2, 2, cfg.d_model
    w = D // n
    moved = lambda op, es, shape: [b for o, b, e, s in seen
                                   if o == op and e == es and s == shape]
    assert moved("all-gather", 2, (Bl, S, w)) == [Bl * S * w * 2] * 4
    assert moved("reduce-scatter", 2, (n * Bl, S, w)) == \
        [Bl * S * D * 2 // n] * 4
    assert moved("all-reduce", 4, (Bl, S, 1)) == [Bl * S * 4 // n] * 4


def test_no_collective_inside_the_loop():
    """A step at 8 and at 16 tokens issues the same collectives in the
    same order (their bytes grow with the activations): the cells' loop
    runs on each rank's plain tensors (one head on (1, 2): the sLSTM's
    gathers and the mLSTM's shared heads in play)."""
    cfg = _smoke(n_heads=1)
    short, long_ = (TD.island_step_cost(cfg, B, s, (1, 2))["collectives"]
                    for s in (8, 16))
    assert [op for op, _ in short] == [op for op, _ in long_]
    assert sum(b for _, b in long_) > sum(b for _, b in short)


def test_fit_refuses_a_collective_per_token():
    """The per-token fit extrapolates each collective's bytes, and refuses
    counts whose collectives grow in number with the length (a
    collective inside the loop)."""
    def count_at(s, per_token):
        cost = {k: s * 10 for k in TD._COUNTS}
        cost["collectives"] = [("all-gather", 4 * s)] + \
            [("all-reduce", 8)] * (s if per_token else 1)
        return cost
    got = TD._extrapolated(lambda s: count_at(s, False), 4096, 4)
    assert got["collectives"] == [("all-gather", 4 * 4096),
                                  ("all-reduce", 8)]
    assert got["flops"] == 40960 and got["extrapolated_from"] == [4, 8,
                                                                  12, 16]
    with pytest.raises(ValueError, match="collective ops"):
        TD._extrapolated(lambda s: count_at(s, True), 4096, 4)

