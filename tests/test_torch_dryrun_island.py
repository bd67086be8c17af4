"""The dry run's counts of FSDP×TP within an island (``launch/dryrun.py``
on an island mesh of DTensors with meta blocks, on a ``fake`` process
group), all on meta tensors: a closed form of the FSDP collectives on a
(data 4, model 1) mesh, with and without ``cast_outside_mb``, and one of
a Mamba2 layer's gathers on (2, 2); a layernorm config's island step;
the global FLOPs of the sharded functions against the unsharded count of
the same functions (the dense, cross-attention, MoE/MLA and hybrid
families); the four island variants, and the families they are accepted
for; the port's collectives against JAX's HLO count of the same pair on a
(2, 2) mesh of fake CPU devices (in a subprocess: diloco_60m and
olmoe_1b_7b; run as a script, the file prints another config's ratio);
and the three repairs that came with the island's first slice: xLSTM's
counted bytes affine in the length, and the per-token loop's fit past a
regime change of its peak live bytes, on a smoke config (xlstm_350m ``train_4k`` at one
microbatch, the pair that showed it, takes ~2 CPU minutes: the dry run's
CLI counts it; the bf16 flash kernels' test is
``tests/test_torch_flash_bf16.py``)."""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tree
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun as TD
from repro_torch.launch import op_cost
from repro_torch.models.registry import get_arch, get_smoke_arch
from repro_torch.sharding.spec import MeshShape, param_pspec

SQUARE = MeshShape(("data", "model"), (2, 2))
FSDP_ONLY = MeshShape(("data", "model"), (4, 1))


def _collectives(monkeypatch):
    """Record every counted collective as (op, bytes, element size, shape
    of its input)."""
    seen = []
    real = op_cost._collective

    def spy(func, args):
        got = real(func, args)
        if got is not None:
            seen.append((*got, args[0].element_size(),
                         tuple(args[0].shape)))
        return got
    monkeypatch.setattr(op_cost, "_collective", spy)
    return seen


def _unsharded(monkeypatch, *args, variant, **kw):
    """The same pair counted with no island mesh (plain meta tensors; the
    island variants' config changes do nothing there, and are left out)."""
    variant = {k: v for k, v in variant.items()
               if k not in TD.ISLAND_ONLY_VARIANTS}
    with monkeypatch.context() as m:
        m.setattr(TD, "ISLAND_FAMILIES", ())
        return TD.dryrun_pair(*args, variant=variant, **kw)


@pytest.mark.parametrize("hoisted", [False, True])
def test_fsdp_closed_form(monkeypatch, hoisted):
    """FSDP alone on (data 4, model 1), diloco_60m ``train_4k``, two
    microbatches, remat off: each layer weight (the stacked attention and
    MLP leaves, all FSDP-sharded on their d_model rows) is all-gathered
    in bf16 once per use, a chip receiving 3/4 of it: twice per
    microbatch (its forward product and its input gradient's), or once a
    step with ``cast_outside_mb``; its gradient is reduce-scattered in
    bf16 once per microbatch, a chip sending 3/4 of it. (The embedding
    and the LM head, FSDP-sharded too, are left out: DTensor gathers the
    int32 tokens for the embedding instead of its table.)"""
    seen = _collectives(monkeypatch)
    mb = 2
    (rec,) = TD.dryrun_pair(
        "diloco_60m", "train_4k", multi_pod=False, mesh=FSDP_ONLY,
        variant={"microbatches": mb, "remat": False,
                 "cast_outside_mb": hoisted})
    arch = get_arch("diloco_60m")
    shapes, axes = arch.abstract_params(arch.cfg)
    layers = [(tuple(s.shape), ax) for (path, s), ax in
              zip(tree.flatten_with_path(shapes), tree.leaves(axes))
              if path[0][1] == "stack0" and s.dim() > 2]
    assert layers and all("data" in param_pspec(ax, shp, FSDP_ONLY)
                          for shp, ax in layers)
    full = sum(math.prod(shp) for shp, _ in layers) * 2     # bf16 bytes
    # a layer weight's blocks (its rows over the 4 data ranks), of the
    # stacked leaf (hoisted) or of one layer's slice of it
    blocks = {math.prod(shp[i:]) // 4 for shp, _ in layers for i in (0, 1)}
    ag = sum(b for op, b, es, shp in seen if op == "all-gather"
             and es == 2 and math.prod(shp) in blocks)
    rs = sum(b for op, b, es, shp in seen if op == "reduce-scatter"
             and es == 2 and math.prod(shp) // 4 in blocks)
    uses = 1 if hoisted else 2 * mb
    assert ag == full * 3 // 4 * uses
    assert rs == full * 3 // 4 * mb
    # the record's per-chip bytes hold them all, and no TP collective:
    # the model axis has one rank
    c = rec["collectives"]
    assert c["intra_pod_bytes"] == sum(b for _, b, _, _ in seen)
    assert c["by_op"]["all-gather"] >= ag
    assert c["by_op"]["reduce-scatter"] >= rs
    assert rec["variant"]["cast_outside_mb"] is hoisted


def test_mamba2_gathers_closed_form(monkeypatch):
    """One Mamba2 layer of zamba2 at full width (one group: the layer and
    the SHARED block), 2 × 64 tokens, one microbatch, remat off, on (data
    2, model 2). ``in_proj``'s columns [z | x | B | C | dt] are cut into
    blocks that do not follow the heads, so each rank reads it whole:
    gathered in bf16 over both axes, a chip receives 3/4 of it once, and
    its gradient is reduce-scattered back over both, a chip sending 3/4
    of it. ``out_proj``'s rows follow the heads: each rank gathers its
    own rows over "data" only (1/4 of the weight a chip) and
    reduce-scatters their gradient there (1/4)."""
    seen = _collectives(monkeypatch)
    cfg = get_arch("zamba2_2_7b").cfg.replace(
        n_layers=1, shared_attn_every=1, remat=False,
        compute_dtype="bfloat16")
    D, d_inner, N, H = cfg.d_model, 2 * cfg.d_model, cfg.ssm_state, \
        cfg.ssm_heads
    cost = TD.island_step_cost(cfg, 2, 64, (2, 2))
    w_in = D * (2 * d_inner + 2 * N + H)
    w_out = d_inner * D
    moved = lambda op, sizes: sum(b for o, b, es, shp in seen
                                  if o == op and es == 2
                                  and math.prod(shp) in sizes)
    # an all-gather's input is a block of the weight, a reduce-scatter's
    # the gradient it is cut from: a quarter or a half of in_proj, the
    # data axis's half of a rank's rows of out_proj
    assert moved("all-gather", (w_in // 4, w_in // 2)) == 2 * w_in * 3 // 4
    assert moved("reduce-scatter", (w_in, w_in // 2)) == 2 * w_in * 3 // 4
    assert moved("all-gather", (w_out // 4,)) == 2 * w_out // 4
    assert moved("reduce-scatter", (w_out // 2,)) == 2 * w_out // 4
    assert cost["collectives"] == [(op, b) for op, b, _, _ in seen]


def test_layernorm_island_step():
    """A layernorm over the island's d_model-sharded residual stream
    (stablelm's smoke config, float32 compute, on (2, 2)): its mean is a
    sum reduced over "model", so the step's backward runs (DTensor's own
    mean was a partial average, and its gradient, a partial sum, could
    not be brought back to it: the step raised) and its count holds the
    reduce."""
    cost = TD.island_step_cost(get_smoke_arch("stablelm_1_6b").cfg, 4, 16,
                               (2, 2))
    assert cost["flops"] > 0 and ("all-reduce", 64) in cost["collectives"]


# qwen3's 64 query heads split over 16 model ranks where its 8 kv heads
# cannot: each rank reads the kv head of its 4 query heads
KV_REPLICATED = MeshShape(("data", "model"), (1, 16))


@pytest.mark.parametrize("arch_name,shape,variant,mesh", [
    ("diloco_60m", "train_4k", {"microbatches": 2}, SQUARE),
    ("diloco_60m", "decode_32k", {}, SQUARE),
    ("diloco_60m", "decode_32k", {"decode_kv_shard": "model"}, SQUARE),
    ("diloco_60m", "prefill_32k", {"seq_parallel": True}, SQUARE),
    ("diloco_60m", "prefill_32k", {"no_act_shard": True}, SQUARE),
    ("whisper_large_v3", "decode_32k", {}, SQUARE),
    ("qwen3_32b", "decode_32k", {}, KV_REPLICATED),
    # the MoE/MLA family: the grouped dispatch, the experts over "model",
    # MLA's heads, its latent ring's features over "model" at decode
    ("olmoe_1b_7b", "train_4k", {"microbatches": 1}, SQUARE),
    ("olmoe_1b_7b", "decode_32k", {}, SQUARE),
    ("deepseek_v2_lite_16b", "train_4k", {"microbatches": 1}, SQUARE),
    ("deepseek_v2_lite_16b", "prefill_32k", {}, SQUARE),
    ("deepseek_v2_lite_16b", "decode_32k", {}, SQUARE),
    # the hybrid family: each rank's own Mamba2 heads, B and C whole, the
    # decode state read from N over "model"; the SHARED block
    ("zamba2_2_7b", "train_4k", {"microbatches": 1}, SQUARE),
    ("zamba2_2_7b", "prefill_32k", {}, SQUARE),
    ("zamba2_2_7b", "decode_32k", {}, SQUARE),
], ids=lambda x: "x".join(map(str, x.shape)) if isinstance(x, MeshShape)
    else None)
def test_global_flops_equal_unsharded(monkeypatch, arch_name, shape,
                                      variant, mesh):
    """The island functions' FLOPs, counted at the DTensor ops' global
    shapes (and each rank's local attention, Mamba2 scan or xLSTM cells
    once for every block it stands for), equal the unsharded count of the
    same function (a Mamba2 train step's by a closed form more: the
    products of its SSD scores' backward, which each model rank runs; an
    xLSTM step's where a head is cut over model ranks; the xLSTM case,
    xlstm_350m at (2, 2), runs in ``tests/test_torch_dryrun_xlstm.py``);
    their
    memory is one chip's (its local blocks), and their within-island
    collectives are counted (the island variants among them)."""
    (sh,) = TD.dryrun_pair(arch_name, shape, multi_pod=False, mesh=mesh,
                           variant=variant)
    (un,) = _unsharded(monkeypatch, arch_name, shape, multi_pod=False,
                       mesh=mesh, variant=variant)
    extra = 0
    cfg = get_arch(arch_name).cfg
    if cfg.family == "hybrid" and shape == "train_4k":
        # Mamba2's SSD scores C·Bᵀ have no head dim: counted once per
        # batch block forward, but their backward products (dC = dS·B,
        # dB = dSᵀ·C) run on each model rank, over its heads' share of dS
        s = SHAPES[shape]
        extra = cfg.n_layers * 2 * (2 * s.global_batch * s.seq_len
                                    * cfg.ssm_chunk * cfg.ssm_state) * (
            mesh.sizes["model"] - 1)
    assert sh["flops"] == un["flops"] + extra and sh["dots"] == un["dots"]
    # bytes: the same ops, but for the redistributions' local copies and
    # the flash-decoding blocks' softmax statistics (~9 % more at decode)
    assert sh["hbm_bytes"] == pytest.approx(un["hbm_bytes"], rel=0.1)
    c = sh["collectives"]
    assert isinstance(c["intra_pod_bytes"], int) and \
        c["intra_pod_bytes"] > 0 and "intra_pod" not in c
    assert sh["roofline"]["collective_intra_s"] > 0
    assert un["collectives"]["intra_pod_bytes"] is None
    assert sh["memory"]["peak_bytes_est"] > 0


@pytest.mark.parametrize("arch_name,accepted", [
    ("olmoe_1b_7b", True), ("deepseek_v2_lite_16b", True),
    ("zamba2_2_7b", True), ("xlstm_350m", True)])
@pytest.mark.parametrize("variant", TD.ISLAND_ONLY_VARIANTS)
def test_island_variants_by_family(arch_name, accepted, variant):
    """The four island variants are accepted for the MoE/MLA, hybrid
    (Mamba2) and ssm (xLSTM) families, whose models run on an island's
    DTensors: every family does, and no variant is refused by family."""
    family = get_arch(arch_name).cfg.family
    assert (family in TD.ISLAND_FAMILIES) is accepted
    value = {"decode_kv_shard": "model"}.get(variant, True)
    TD._check_variant({variant: value}, "auto")


JAX_HLO = r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.dryrun as DR
from repro.launch import hlo_analysis as H
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
seen = {}
real = H.collective_stats
def spy(hlo, **kw):
    seen["hlo"] = hlo
    return real(hlo, **kw)
H.collective_stats = spy
(rec,) = DR.dryrun_pair(sys.argv[1], "train_4k", multi_pod=False,
                        microbatches=int(sys.argv[2]), mesh=mesh)
hlo = seen["hlo"]
comps = H._split_computations(hlo)
mults = H.computation_multipliers(hlo)
size = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
        "s8": 1, "u8": 1, "pred": 1, "s64": 8}
INST = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*?)\s([\w\-]+)"
                  r"\(([^)]*)\)(.*)$")
insts = {}
for name, body in comps.items():
    insts[name] = []
    for line in body.splitlines():
        m = INST.match(line)
        if m:
            ops = [o.strip().lstrip("%") for o in
                   re.sub(r"/\*.*?\*/", "", m.group(4)).split(",")
                   if o.strip()]
            insts[name].append((m.group(1), m.group(3), ops, m.group(5),
                                m.group(2)))
params = {c: {int(i[2][0]): i[0] for i in lst if i[1] == "parameter"}
          for c, lst in insts.items()}


def sliced(comp, value):
    # every use of value ends in a (dynamic-)slice of it, through
    # converts, copies, bitcasts, reshapes, tuple reads and fusions
    users = [i for i in insts[comp] if value in i[2]]
    if not users:
        return False
    for name, op, ops, attrs, _ in users:
        if op in ("dynamic-slice", "slice") and ops[0] == value:
            continue
        if op in ("convert", "bitcast", "copy", "reshape",
                  "get-tuple-element") and len(ops) == 1:
            if sliced(comp, name):
                continue
            return False
        if op == "fusion":
            callee = re.search(r"calls=%([\w.\-]+)", attrs).group(1)
            if all(sliced(callee, params[callee][k])
                   for k, o in enumerate(ops) if o == value):
                continue
        return False
    return True


def elements(ty):
    return [int(np.prod([int(d) for d in dims.split(",") if d]))
            if t in size else 0 for t, dims in re.findall(r"(\w+)\[([\d,]*)\]", ty)]


# an all-reduce whose every use slices it (each tuple element on its
# own) is a reduce-scatter that XLA's CPU partitioner left unfused
elems = {}
for name, lst in insts.items():
    if name == "__entry__":
        continue
    mult = mults.get(name, 1)
    for inst, op, ops, attrs, ty in lst:
        op = op[:-len("-start")] if op.endswith("-start") else op
        if op not in H._COLLECTIVES:
            continue
        for i, n in enumerate(elements(ty)):
            kind = op
            if op == "all-reduce":
                if ty.startswith("("):
                    parts = [g[0] for g in lst if g[1] == "get-tuple-element"
                             and g[2] == [inst]
                             and re.search(rf"index={i}\b", g[3])]
                else:
                    parts = [inst]
                if parts and all(sliced(name, g) for g in parts):
                    kind = "all-reduce-sliced"
            elems[kind] = elems.get(kind, 0) + n * mult
print(json.dumps({"by_op": rec["collectives"]["by_op"], "elems": elems}))
"""


def test_collectives_against_jax_hlo(monkeypatch):
    """diloco_60m ``train_4k`` (two microbatches) on a (2, 2) mesh: the
    port's counted collectives against JAX's HLO count of the same pair on
    four fake CPU devices. JAX's CPU partitioner emits no reduce-scatter:
    it reduces a product's partial sums with an all-reduce and slices the
    result. Each of JAX's all-reduces is classified from the HLO: one
    whose every use slices it (through converts, copies, tuple reads and
    fusions) is a reduce-scatter, the rest are all-reduces. Every op the
    port counts appears in JAX's, the port's reduce-scatter as a sliced
    all-reduce, its all-to-all (DTensor's move of a tensor from one shard
    dim to another, ``_dtensor.shard_dim_alltoall``) as an all-to-all or,
    on these axes of two devices, the collective-permute that trades the
    two halves. The totals per chip are compared as elements a chip moves,
    whatever their dtype (XLA's CPU pipeline carries the model's bf16
    activations as f32): an all-gather's (n−1)/n of its result, a
    reduce-scatter's (n−1)/n of its input, an all-reduce's 2(n−1)/n, a
    permute's whole tensor. They agree within a factor of 2."""
    _hold_to_jax_hlo(monkeypatch, "diloco_60m", 2)


def test_moe_collectives_against_jax_hlo(monkeypatch):
    """olmoe_1b_7b ``train_4k`` (one microbatch) on a (2, 2) mesh, held to
    JAX's HLO as ``test_collectives_against_jax_hlo`` holds diloco_60m:
    the MoE dispatch's three constrain sites, the experts over "model".
    JAX's CPU partitioner emits no all-to-all for the dispatch or its
    return (an all-gather of the experts' output, as the port's); an
    all-to-all would be counted as such. Every op the port counts appears
    in JAX's (the port's all-to-alls, DTensor's moves between shard dims
    of the residual stream, as collective-permutes), and the elements a
    chip moves agree within a factor of 2."""
    _hold_to_jax_hlo(monkeypatch, "olmoe_1b_7b", 1)


def _hold_to_jax_hlo(monkeypatch, arch, microbatches):
    assert 0.5 <= _jax_over_port(monkeypatch, arch, microbatches) <= 2.0


def _jax_over_port(monkeypatch, arch, microbatches):
    """The elements a chip moves in JAX's CPU lowering of ``arch``'s
    ``train_4k`` on (2, 2) over the port's count (printed with both
    sides' collectives); every op the port counts appears in JAX's."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        ["src", os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_HLO, arch,
                                str(microbatches)], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    seen = _collectives(monkeypatch)
    (rec,) = TD.dryrun_pair(arch, "train_4k", multi_pod=False,
                            mesh=SQUARE,
                            variant={"microbatches": microbatches})
    out, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-2000:]
    jax_rec = json.loads(out.strip().splitlines()[-1])
    jax_ops = set(jax_rec["elems"])
    port_ops = set(rec["collectives"]["by_op"])
    as_jax = {"reduce-scatter": {"all-reduce-sliced"},
              "all-to-all": {"all-to-all", "collective-permute"}}
    assert all(as_jax.get(op, {op}) & jax_ops for op in port_ops), \
        (port_ops, jax_ops)
    n = 2
    share = {"all-gather": (n - 1) / n, "all-reduce": 2 * (n - 1) / n,
             "all-reduce-sliced": (n - 1) / n, "reduce-scatter": (n - 1) / n,
             "all-to-all": (n - 1) / n, "collective-permute": 1.0}
    # the port's bytes are what a chip hands its collectives, an
    # all-reduce's (n−1)/n each way: elements by dtype
    port = sum(b // es * (2 if op == "all-reduce" else 1)
               for op, b, es, _ in seen)
    jax_moved = sum(share[op] * e for op, e in jax_rec["elems"].items())
    ratio = jax_moved / port
    # (every JAX all-reduce at an all-reduce's 2(n−1)/n, for the record)
    unsliced = ratio + jax_rec["elems"].get("all-reduce-sliced", 0) * (
        n - 1) / n / port
    print(f"per chip: port {port:.4e} elements moved, JAX {jax_moved:.4e} "
          f"(ratio {ratio:.3f}; {unsliced:.3f} with no all-reduce taken for "
          f"a reduce-scatter); JAX elements {jax_rec['elems']}, port bytes "
          f"{rec['collectives']['by_op']}")
    return ratio


def _smoke_train_cost(arch, cfg, S, *, mb=1, B=2):
    p = TD._meta_params(arch, cfg, torch.float32)[0]
    fn = TD.build_train_step(arch, cfg, groups=1, microbatches=mb)
    batch = arch.input_specs(ShapeConfig("t", S, B, "train"),
                             dtype=torch.bfloat16)
    return TD._count(fn, (p, tree.map(TD._meta_like, p),
                          tree.map(TD._meta_like, p), 0, batch))


def test_xlstm_step_bytes_are_affine_in_length():
    """The xLSTM cells' per-token slices are unbound once before the loop,
    so the backward stacks the per-token gradients in one op: a train
    step's counted bytes (and FLOPs) are affine in the length (they grew
    with its square when each token's slice wrote a full-length zero
    gradient)."""
    arch = get_smoke_arch("xlstm_350m")
    cfg = arch.cfg.replace(compute_dtype="bfloat16")
    got = [_smoke_train_cost(arch, cfg, S) for S in (8, 16, 24, 32)]
    for key in ("bytes", "bytes_min", "flops"):
        ys = [g[key] for g in got]
        assert ys[2] - ys[1] == ys[1] - ys[0] == ys[3] - ys[2], (key, ys)


def test_extrapolation_moves_past_a_regime_change(monkeypatch):
    """The smoke xLSTM config at batch 2 and one microbatch changes the
    regime of its peak live bytes at 16 tokens (as xlstm_350m ``train_4k``
    does at 20): the fit moves past it and is exact at a longer length
    counted directly; a window that cannot move is refused."""
    arch = get_smoke_arch("xlstm_350m")
    cfg = arch.cfg.replace(compute_dtype="bfloat16")
    cache = {}

    def at(S):
        if S not in cache:
            cache[S] = _smoke_train_cost(arch, cfg, S)
        return cache[S]
    with monkeypatch.context() as m:         # a window that cannot move
        m.setattr(TD, "FIT_SHIFTS", 0)
        with pytest.raises(ValueError, match="peak_live_bytes"):
            TD._extrapolated(at, 64, 4)
    got = TD._extrapolated(at, 64, 4)
    assert got["extrapolated_from"][0] > 4
    want = _smoke_train_cost(arch, cfg, 64)
    for key in TD._COUNTS:
        assert got[key] == want[key], key


if __name__ == "__main__":
    # the ratio of another config, e.g. zamba2_2_7b at one microbatch
    # (2.414, beyond the tests' factor of 2): PYTHONPATH=src python
    # tests/test_torch_dryrun_island.py zamba2_2_7b 1
    with pytest.MonkeyPatch.context() as mp:
        _jax_over_port(mp, sys.argv[1], int(sys.argv[2]))
