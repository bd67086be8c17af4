"""Dry run: every (architecture × input shape) counted at full size on
meta tensors, allocating nothing (the JAX ``launch/dryrun.py``, which
lowers and compiles each pair on 512 fake devices).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod \\
        --arch diloco_150m --shape train_4k --fns main,stream,gossip

Per (arch × shape), the functions JAX lowers:
  single island, mesh (data 16, model 16) read as H100s
    train_4k     -> inner_train_step  (microbatched AdamW step)
    prefill_32k  -> prefill
    decode_32k   -> serve_step (1 new token against a seq_len cache)
    long_500k    -> serve_step (sliding window / recurrent state)
  two islands, mesh (pod 2, data 16, model 16) [--multi-pod]: one rank's
  view, the port's own functions on a ``comm_analysis.CountingGroup``
    train_4k     -> diloco_inner_step   (the island's step, as
                    inner_train_step's: no group call at all)
                 -> diloco_outer_step   (the replicas' mean by
                    ``pod_collectives.fragment_mean``, the sharded f32
                    transport's reduce, then the Nesterov update)
                 -> ddp_train_step      (every step's gradients
                    all-reduced)
                 -> diloco_stream_round [--fns stream] (the sharded
                    streaming round: P=2 fragments, H=4, 2 rounds)
                 -> gossip_exchange     [--fns gossip] (one butterfly
                    exchange, ``gossip.pod_mix_round``)
    serve shapes -> the same functions, each island serving its share
                    of the batch

Each record: ``op_cost``'s FLOPs and bytes (global totals: one island's
count times the islands that each do their own share of the work; work
every island repeats, the outer update or an unsplit batch, counts
once), the collectives
(per chip: a rank's counted bytes spread over its island's chips),
``comm_analysis.roofline`` on the H100's rates, and the memory per chip
against the card's (``comm_analysis.memory_items``): arguments from the
specs' shard bytes (``sharding/spec.py``: FSDP×TP params, batch over
data), temporaries from the meta run's peak of live storage divided by
the batch's mesh axes.

What the JAX dry run has and this one does not:
  * within-island collectives (GSPMD's FSDP all-gathers, TP reduces):
    the port runs no model parallelism within an island, so they are
    reported as not modelled (``intra_pod_bytes`` None), not as 0 bytes;
  * the variants that only steer those collectives (``cast_outside_mb``,
    ``decode_kv_shard``, ``seq_parallel``, ``no_act_shard``) are refused;
  * XLA's own cost analysis (``xla_flops``, ``xla_bytes``).
Kernel modes: ``auto`` counts each kernel wrapper as one fused leaf
(``op_cost``), ``ref`` runs the plain versions on meta; ``kernel``,
``pallas`` and ``interpret`` are refused.

Per-token loops: the xLSTM cells step once per token (a Python loop of
~15 ops a step, 24 blocks), which would dispatch tens of millions of
ops at 4k or 32k tokens. For a family with such a loop the train and
prefill functions are counted at four short lengths (4, 8, 12, 16 tokens
for a train step, 32 to 128 for a prefill: ``FIT_STEP``) and
extrapolated to S by the quadratic through three of them, which must
give the fourth exactly (else the pair fails): no trip multiplier is
applied anywhere.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from fractions import Fraction

import torch

from .. import tree
from ..configs.base import SHAPES, DiLoCoConfig, ShapeConfig, TrainConfig
from ..core import diloco, gossip, pod_collectives, streaming
from ..kernels import ops as kops
from ..models import model as M
from ..models.registry import ARCH_NAMES, Arch, get_arch
from ..obs import metrics as obs_metrics
from ..optim import adamw
from ..sharding.spec import (MeshShape, batch_pspec, entry_axes,
                             logical_to_pspec, production_mesh, shard_bytes)
from . import comm_analysis as C
from .op_cost import counting

META = torch.device("meta")
TRAIN_MICROBATCHES = 8
STREAM_FRAGMENTS = 2
STREAM_H = 4
STREAM_ROUNDS = 2
STREAM_TAU = 0
KERNEL_MODES = ("auto", "ref")
VARIANTS = ("fsdp", "pure_dp", "remat", "microbatches", "moe_groups")
# variants of the JAX dry run that only move GSPMD's collectives within an
# island, which the port does not run
ISLAND_ONLY_VARIANTS = ("cast_outside_mb", "decode_kv_shard",
                        "seq_parallel", "no_act_shard")
NOT_MODELLED = ("within-island collectives (FSDP x TP over data and model) "
                "are not modelled: the port runs no model parallelism "
                "within an island (ROADMAP.md §1)")


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def param_pspec(axes: tuple, shape: tuple, mesh: MeshShape,
                fsdp: bool = True) -> tuple:
    """2-D param sharding: model-parallel pass (priority rules), then an
    FSDP pass putting 'embed' rows on "data" if still free.

    Exception, as in the JAX dry run: *gathered* tables (axes start with
    "vocab") whose vocab dim does not divide the model axis are fully
    replicated (a gather from a feature-sharded table mis-lowers under
    XLA's SPMD partitioner, and a data-sharded table is all-gathered every
    step anyway)."""
    sizes = mesh.sizes
    if (axes and axes[0] == "vocab" and "model" in sizes
            and shape[0] % sizes["model"] != 0):
        return (None,) * len(axes)
    spec = list(logical_to_pspec(axes, shape, mesh))
    if fsdp and "data" in sizes and "data" not in spec:
        for i, name in enumerate(axes):
            if (spec[i] is None and name == "embed"
                    and shape[i] % sizes["data"] == 0):
                spec[i] = "data"
                break
    return tuple(spec)


def cache_pspec(shape: tuple, mesh: MeshShape, *, include_pod: bool) -> tuple:
    """Decode-cache sharding: leading (groups) dim replicated, batch dim
    over ("pod"?, "data") when divisible, and ONE more dim over "model"
    (kv-heads first, then the sequence dim, then feature dims); a batch too
    small for "data" puts the sequence dim on it instead."""
    sizes = mesh.sizes
    nd = len(shape)
    spec = [None] * nd
    if nd >= 2:
        axes = []
        if include_pod and "pod" in sizes:
            axes.append("pod")
        axes.append("data")
        total = math.prod(sizes[a] for a in axes)
        while axes and shape[1] % total != 0:
            total //= sizes[axes.pop()]
        if axes:
            spec[1] = tuple(axes) if len(axes) > 1 else axes[0]
    if "model" in sizes and nd >= 3:
        for i in [3, 2, nd - 1, nd - 2]:
            if 2 <= i < nd and spec[i] is None \
                    and shape[i] % sizes["model"] == 0 and shape[i] > 1:
                spec[i] = "model"
                break
    if spec[1] is None and "data" in sizes and nd >= 4:
        for i in [2, nd - 2]:
            if 2 <= i < nd and spec[i] is None \
                    and shape[i] % sizes["data"] == 0 and shape[i] > 1:
                spec[i] = "data"
                break
    return tuple(spec)


def _tree_shard_bytes(params, axes, mesh, *, fsdp=True, pure_dp=False):
    if pure_dp:
        return sum(t.numel() * t.element_size() for t in tree.leaves(params))
    return sum(shard_bytes(t, param_pspec(ax, tuple(t.shape), mesh, fsdp),
                           mesh)
               for t, ax in zip(tree.leaves(params), tree.leaves(axes)))


def _cache_shard_bytes(cache, mesh, *, include_pod):
    total = 0
    for _, t in tree.flatten_with_path(cache):
        spec = cache_pspec(tuple(t.shape), mesh, include_pod=include_pod) \
            if t.is_floating_point() else (None,) * t.dim()
        total += shard_bytes(t, spec, mesh)
    return total


# ---------------------------------------------------------------------------
# counted functions
# ---------------------------------------------------------------------------

def _meta_params(arch: Arch, cfg, dtype):
    """(meta params with their float leaves at ``dtype``, axes tree)."""
    shapes, axes = arch.abstract_params(cfg)
    return tree.map(lambda s: torch.empty(
        s.shape, dtype=dtype if s.is_floating_point() else s.dtype,
        device=META), shapes), axes


def _meta_like(t, dtype=None):
    return torch.empty(t.shape, dtype=dtype or t.dtype, device=META)


def _cast(params, dtype):
    return tree.map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def build_train_step(arch: Arch, cfg, *, groups: int,
                     microbatches: int = TRAIN_MICROBATCHES,
                     kernel_mode: str = "auto", group=None):
    """(params, m, v, count, batch) -> (params, m, v, count, loss): the JAX
    dry run's step. Gradients of the loss at ``cfg.compute_dtype`` are
    accumulated in float32 over ``microbatches`` splits of the batch, then
    clipped to norm 1 and applied by the port's AdamW (``adamw.update``,
    the fused kernel under ``auto``). With ``group`` (the DDP baseline)
    each accumulated gradient is all-reduced over the pods and divided by
    their count before the clip."""
    cdt = getattr(torch, cfg.compute_dtype)

    def step(params, m, v, count, batch):
        B = batch["tokens"].shape[0]
        mb = microbatches if B % microbatches == 0 else 1
        leaves = tree.leaves(params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        losses = []
        for i in range(mb):
            sub = {k: x[i * B // mb:(i + 1) * B // mb]
                   for k, x in batch.items()}
            req = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = arch.loss(_cast(tree.unflatten(params, req), cdt),
                                sub, cfg=cfg, groups=groups)
            grads = torch.autograd.grad(loss, req, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g.float() / mb)
            losses.append(loss.detach())
        if group is not None:
            for a in acc:
                group.all_reduce(a).div_(group.pods)
        grads, _ = adamw.clip_by_global_norm(tree.unflatten(params, acc),
                                             1.0)
        params, st = adamw.update(grads, adamw.AdamWState(m, v, count),
                                  params, lr=4e-4, mode=kernel_mode)
        return params, st.m, st.v, st.count, torch.stack(losses).mean()

    return step


def build_outer_step(*, k: int, group, kernel_mode: str = "auto"):
    """(global_params, this rank's (k_loc, ...) replica band, buf) ->
    (new_global, new_buf, new_band): the outer gradients' mean over all k
    replicas in ONE all-reduce (``pod_collectives.fragment_mean``, the
    sharded f32 transport's reduce over the whole tree), then the fused
    Nesterov update; the band adopts the new global params."""
    def step(global_params, band, buf):
        k_loc = tree.leaves(band)[0].shape[0]
        gl, bl = tree.leaves(global_params), tree.leaves(band)
        dev = gl[0].device
        deltas = [g[None] - r for g, r in zip(gl, bl)]
        means = pod_collectives.fragment_mean(
            deltas, torch.ones((k_loc,), device=dev),
            torch.full((), float(k), device=dev), group=group)
        new_global, new_buf = kops.nesterov_update_tree(
            global_params, tree.unflatten(global_params, means), buf,
            lr=0.7, momentum=0.9, mode=kernel_mode)
        for g, r in zip(tree.leaves(new_global), bl):
            r.copy_(g[None].expand(r.shape))
        return new_global, new_buf, band

    return step


def build_stream_run(arch: Arch, cfg, *, k: int, group, batch: int,
                     seq_len: int, fragments_: int = STREAM_FRAGMENTS,
                     H_inner: int = STREAM_H, rounds: int = STREAM_ROUNDS,
                     kernel_mode: str = "auto", wire_dtype: str = "float32",
                     tau: int = STREAM_TAU):
    """The sharded streaming DiLoCo round (``diloco.make_round`` with
    ``transport="sharded"``) on this rank's ``group``: P fragments, each
    synced by a real pod collective at its staggered offset; quantized
    wires take the packed transport (one coalesced all-gather a fragment),
    and ``tau > 0`` defers each consume τ inner steps. Returns
    run(params) -> state, running ``rounds`` rounds from params."""
    dcfg = DiLoCoConfig(k=k, H=H_inner, streaming_fragments=fragments_,
                        transport="sharded", kernel_mode=kernel_mode,
                        outer_grad_dtype=wire_dtype, stream_tau=tau)
    total = rounds * H_inner
    tcfg = TrainConfig(total_steps=total, warmup_steps=1, batch_size=batch,
                       seq_len=seq_len, kernel_mode=kernel_mode)

    def loss_fn(p, b):
        group.inner_step()
        return arch.loss(p, b, cfg=cfg)

    def sample_fn(gen, B, S):
        return torch.empty((k, B, S), dtype=torch.int32, device=META)

    def run(params):
        group.track_overlap()
        rnd = diloco.make_round(loss_fn, sample_fn, dcfg, tcfg,
                                total_steps=total, batch_size=batch,
                                seq_len=seq_len, group=group)
        state = streaming.init_state(params, dcfg, group=group)
        for _ in range(rounds):
            state, _ = rnd(state, None)
        return state

    return run


def build_gossip_exchange(*, k: int, group, stage: int = 0,
                          mix: float = 0.5):
    """(this rank's (k_loc, ...) estimate band) -> band: one butterfly
    pairwise partial-averaging exchange (``gossip.pod_mix_round``), a
    pod permutation and no collective spanning all pods."""
    partner = gossip.partner_map(k, stage, "butterfly")

    def step(est):
        return gossip.pod_mix_round(est, partner,
                                    tree.map(lambda _: 1.0, est), mix=mix,
                                    group=group)

    return step


def build_prefill(arch: Arch, cfg, *, groups: int):
    def fn(params, batch):
        logits, cache = arch.prefill(params, batch, cfg=cfg, groups=groups)
        return logits[:, -1:], cache
    return fn


def build_decode(arch: Arch, cfg, *, groups: int):
    def fn(params, cache, tokens, pos):
        return arch.decode(params, cache, tokens, pos, cfg=cfg,
                           groups=groups)
    return fn


# ---------------------------------------------------------------------------
# per-pair dry run
# ---------------------------------------------------------------------------

def model_flops(param_count: float, active_count: float, shape: ShapeConfig
                ) -> float:
    """6·N_active·D for train, 2·N_active·D for inference."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * active_count * tokens


def count_params(shapes_tree, axes_tree, cfg):
    """(total, active) parameter counts; a leaf with an "experts" axis is
    active at top_k / n_experts."""
    shapes, axes = tree.leaves(shapes_tree), tree.leaves(axes_tree)
    total = sum(math.prod(s.shape) for s in shapes)
    if not cfg.n_experts:
        return float(total), float(total)
    expert = sum(math.prod(s.shape) for s, ax in zip(shapes, axes)
                 if "experts" in ax)
    active = total - expert * (1.0 - cfg.top_k / cfg.n_experts)
    return float(total), float(active)


def vocab_padding(vocab: int, model_axis: int) -> int:
    """Rows the vocab is padded by to a multiple of the model axis
    (production practice: whisper's 51866 -> 51872 on 16); logits over
    the pad ids are unused."""
    return (-vocab) % model_axis


def _per_token_loop(cfg) -> bool:
    """Whether the family steps a Python loop once per token (xLSTM)."""
    return any(k in ("mlstm", "slstm") for k in M.make_plan(cfg).pattern)


_COUNTS = ("flops", "bytes", "bytes_min", "dots", "peak_live_bytes",
           "end_live_bytes")


def _count(fn, args) -> dict:
    """``op_cost`` of fn(*args); the arguments are made before the count
    starts, so they are not among its temporaries."""
    with counting() as c:
        out = fn(*args)
        cost = c.result()
    del out
    return cost


# the lengths a per-token loop is counted at: step × (1, 2, 3, 4) tokens,
# the step by shape kind (a train step's backward and microbatches make
# its tokens dearer; a prefill's peak memory settles on its asymptote
# only past some tens of tokens)
FIT_STEP = {"train": 4, "prefill": 32}


def _quadratic_at(xs, ys, x):
    """The quadratic through (xs[i], ys[i]), i < 3, at x (exact)."""
    total = Fraction(0)
    for i in range(3):
        term = Fraction(ys[i])
        for j in range(3):
            if j != i:
                term *= Fraction(x - xs[j], xs[i] - xs[j])
        total += term
    return total


def _extrapolated(count_at, S: int, step: int) -> dict:
    """Counts at S from four short lengths, ``step`` × (1, 2, 3, 4): each
    count is fitted by the quadratic through the first three and checked
    on the fourth (exactly), then evaluated at S; a count that is no such
    polynomial of the length fails the pair. (Quadratic, not affine: the
    backward of the per-token slices writes a full-length zero gradient a
    token, so bytes grow with S².)"""
    lens = [step * i for i in (1, 2, 3, 4)]
    got = [count_at(s) for s in lens]
    out = dict(got[0])
    for key in _COUNTS:
        ys = [g[key] for g in got]
        if _quadratic_at(lens, ys, lens[3]) != ys[3]:
            raise ValueError(
                f"{key} is not a quadratic in the length "
                f"({list(zip(lens, ys))}): cannot extrapolate")
        out[key] = int(round(_quadratic_at(lens, ys, S)))
    out["extrapolated_from"] = lens
    return out


def _check_variant(variant: dict, kernel_mode: str):
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(
            f"kernel_mode={kernel_mode!r}: the dry run takes {KERNEL_MODES} "
            "('kernel' needs CUDA tensors; 'pallas' and 'interpret' name "
            "TPU machinery the port has no counterpart of)")
    for key in variant:
        if key in ISLAND_ONLY_VARIANTS:
            raise ValueError(
                f"variant {key!r} only changes GSPMD's collectives within "
                "an island, which the port does not run (ROADMAP.md §1: "
                "within-island model parallelism)")
        if key not in VARIANTS:
            raise ValueError(f"unknown variant {key!r}; the dry run takes "
                             f"{VARIANTS}")


def _per_chip(stats: C.CollectiveStats, chips: int) -> C.CollectiveStats:
    """A rank's counted bytes spread over its island's ``chips``."""
    out = C.CollectiveStats(count=stats.count,
                            cross_count_by_op=dict(stats.cross_count_by_op))
    for op, nb in stats.by_op.items():
        share = -(-nb // chips)
        out.by_op[op] = out.cross_by_op[op] = share
        out.total_bytes += share
        out.cross_pod_bytes += share
    return out


def dryrun_pair(arch_name: str, shape_name: str, *, multi_pod: bool,
                microbatches: int = TRAIN_MICROBATCHES,
                fns: tuple = ("main",), mesh: MeshShape | None = None,
                variant: dict | None = None, kernel_mode: str = "auto",
                stream_wire: str = "float32",
                stream_tau: int = STREAM_TAU) -> list[dict]:
    """Count the pair; returns one record per counted function.

    ``variant`` (recorded in each record):
      fsdp: bool          — False: params model-sharded only (1-D TP)
      pure_dp: bool       — params replicated, batch over every mesh axis
      remat: bool         — override activation checkpointing
      microbatches: int   — override accumulation factor
      moe_groups: int     — override MoE token-grouping factor
    """
    variant = dict(variant or {})
    _check_variant(variant, kernel_mode)
    microbatches = int(variant.get("microbatches", microbatches))
    t0 = time.time()
    arch = get_arch(arch_name)
    shape = SHAPES[shape_name]
    cfg = arch.shape_cfg(shape)
    train = shape.kind == "train"
    # training: f32 master params, bf16 compute; serving: bf16 params
    cfg = cfg.replace(compute_dtype="bfloat16",
                      param_dtype="float32" if train else "bfloat16")
    if "remat" in variant:
        cfg = cfg.replace(remat=bool(variant["remat"]))
    fsdp = bool(variant.get("fsdp", True))
    pure_dp = bool(variant.get("pure_dp", False))
    mesh = mesh or production_mesh(multi_pod=multi_pod)
    chips = mesh.devices
    sizes = mesh.sizes
    pods = sizes.get("pod", 1)
    island = MeshShape(tuple(a for a in mesh.axis_names if a != "pod"),
                       tuple(n for a, n in sizes.items() if a != "pod"))
    cpp = island.devices if "pod" in sizes else None
    groups = int(variant.get("moe_groups", sizes.get("data", 1)))
    k = pods

    vocab_pad = vocab_padding(cfg.vocab_size, sizes.get("model", 1))
    if vocab_pad:
        cfg = cfg.replace(vocab_size=cfg.vocab_size + vocab_pad)

    pdtype = torch.float32 if train else torch.bfloat16
    pshapes, paxes = _meta_params(arch, cfg, pdtype)
    total_p, active_p = count_params(pshapes, paxes, cfg)
    mf = model_flops(total_p, active_p, shape)
    in_specs = arch.input_specs(shape, dtype=torch.bfloat16)
    tok_shape = tuple(in_specs["tokens"].shape)
    # each island's batch: the global batch split over the pods; a batch
    # too small to split is served whole by every island, and that
    # replicated work counts once in the global totals (as one program
    # counts it in JAX's)
    split = tok_shape[0] % k == 0
    B_isl = tok_shape[0] // k if split else tok_shape[0]
    serving = pods if split else 1
    if pure_dp and B_isl % island.devices == 0:
        batch_axes = tuple(island.axis_names)
    else:
        batch_axes = batch_pspec(island, B_isl, 2)[0]
    shards = math.prod(sizes[a] for a in entry_axes(batch_axes))
    param_b = _tree_shard_bytes(pshapes, paxes, island, fsdp=fsdp,
                                pure_dp=pure_dp)
    batch_b = lambda B: sum(
        -(-B // shards) * math.prod(v.shape[1:]) * v.element_size()
        for v in in_specs.values())

    records = []
    base = {"arch": arch_name, "shape": shape_name,
            "mesh": "x".join(map(str, mesh.shape)),
            "multi_pod": multi_pod, "chips": chips,
            "params": total_p, "active_params": active_p,
            "model_flops": mf, "tokens": list(tok_shape),
            "vocab_pad": vocab_pad, "variant": variant,
            "microbatches": microbatches if train else 1,
            "kernel_mode": kernel_mode}

    def batch_of(B, S):
        return arch.input_specs(ShapeConfig(shape.name, S, B, shape.kind),
                                dtype=torch.bfloat16)

    def record(name, cost, arg_bytes, *, islands, group=None,
               temp_shards=None):
        """One function's record from one island's ``cost``; ``islands``:
        how many islands run it (its global totals). Its temporaries are
        divided by the batch's shards, or by ``temp_shards`` (a function
        without a batch: its param-shaped temporaries spread over the
        island)."""
        stats = C.CollectiveStats() if group is None \
            else _per_chip(group.stats, cpp)
        flops = cost["flops"] * islands
        nbytes = cost["bytes"] * islands
        nbytes_min = cost["bytes_min"] * islands
        terms = C.roofline(flops, nbytes, stats, chips=chips)
        terms["memory_min_s"] = nbytes_min / (chips * C.HBM_BW)
        # the stats hold no within-island bytes: that term is not modelled
        terms["collective_intra_s"] = None
        terms["model_flops_ratio"] = mf / flops if flops else 0.0
        coll = stats.as_dict()
        coll["intra_pod_bytes"] = None
        coll["intra_pod"] = NOT_MODELLED
        if group is not None:
            coll["per_rank"] = group.stats.as_dict()
            coll["traffic"] = dict(group.traffic)
        rec = {"fn": name, "flops": flops, "hbm_bytes": nbytes,
               "hbm_bytes_min": nbytes_min, "dots": cost["dots"] * islands,
               "fused_leaves_per_island": cost["leaves"],
               "collectives": coll, "roofline": terms,
               "memory": C.memory_items(arg_bytes, cost,
                                        batch_shards=temp_shards or shards),
               **base}
        if "extrapolated_from" in cost:
            rec["extrapolated_from"] = cost["extrapolated_from"]
        rec["compile_s"] = round(time.time() - t0, 1)
        records.append(rec)
        return rec

    def counted(make, S):
        """Cost of fn(*args), (fn, args) = make(s), at S tokens;
        extrapolated for a per-token loop."""
        at = lambda s: _count(*make(s))
        if _per_token_loop(cfg) and shape.kind != "decode":
            return _extrapolated(at, S, FIT_STEP[shape.kind])
        return at(S)

    def fresh_params(dtype=torch.float32):
        return _meta_params(arch, cfg, dtype)[0]

    def band(p):                  # this rank's (1, ...) replica band
        return tree.map(lambda t: torch.empty((1,) + tuple(t.shape),
                                              device=META), p)

    S = shape.seq_len
    no_batch = 1 if pure_dp else island.devices
    if train:
        opt_b = 2 * param_b               # AdamW m, v at f32, as the params
        state_b = lambda B: param_b + opt_b + batch_b(B)

        def step(B, made=None):
            """(fn, args) of the train step at s tokens; with ``made`` (a
            list), a fresh ``CountingGroup`` for each count, appended
            there (the DDP baseline's: one count's collectives each)."""
            def make(s):
                p = fresh_params()
                group = None
                if made is not None:
                    group = C.CountingGroup(0, pods)
                    made.append(group)
                fn = build_train_step(arch, cfg, groups=groups,
                                      microbatches=microbatches,
                                      kernel_mode=kernel_mode, group=group)
                return fn, (p, tree.map(_meta_like, p),
                            tree.map(_meta_like, p), 0, batch_of(B, s))
            return make

        if not multi_pod:
            record("inner_train_step", counted(step(tok_shape[0]), S),
                   state_b(tok_shape[0]), islands=1)
        else:
            if "main" in fns or "inner" in fns:
                g = C.CountingGroup(0, pods)
                record("diloco_inner_step", counted(step(B_isl), S),
                       state_b(B_isl), islands=pods, group=g)
            if "main" in fns or "outer" in fns:
                g = C.CountingGroup(0, pods)
                p = fresh_params()
                cost = _count(build_outer_step(k=k, group=g,
                                               kernel_mode=kernel_mode),
                              (p, band(p), tree.map(_meta_like, p)))
                # every island applies the same update to the same global
                # params: replicated work, counted once
                record("diloco_outer_step", cost, 3 * param_b,
                       islands=1, group=g, temp_shards=no_batch)
            if "stream" in fns:
                made = []

                def stream(s):
                    g = C.CountingGroup(0, pods)
                    made.append(g)
                    return build_stream_run(
                        arch, cfg, k=k, group=g, batch=max(1, B_isl),
                        seq_len=s, kernel_mode=kernel_mode,
                        wire_dtype=stream_wire, tau=stream_tau), \
                        (fresh_params(),)
                cost = counted(stream, S)
                g = made[-1]
                rec = record("diloco_stream_round", cost, state_b(B_isl),
                             islands=pods, group=g)
                prof = C.wire_profile(g, chips_per_pod=cpp,
                                      tau=stream_tau or None)
                rec["stream_interleaving"] = prof["interleaving"]
                rec["stream_overlap"] = {kk: vv for kk, vv in
                                         prof.get("overlap", {}).items()
                                         if kk != "rows"}
                rec["stream_wire"] = stream_wire
                rec["stream_tau"] = stream_tau
            if "gossip" in fns:
                g = C.CountingGroup(0, pods)
                cost = _count(build_gossip_exchange(k=k, group=g),
                              (band(fresh_params()),))
                record("gossip_exchange", cost, param_b, islands=pods,
                       group=g, temp_shards=no_batch)
            if "main" in fns or "ddp" in fns:
                made = []
                cost = counted(step(B_isl, made), S)
                record("ddp_train_step", cost, state_b(B_isl),
                       islands=pods, group=made[-1])
    elif shape.kind == "prefill":
        cost = counted(lambda s: (build_prefill(arch, cfg, groups=groups),
                                  (fresh_params(pdtype), batch_of(B_isl, s))),
                       S)
        record("prefill", cost, param_b + batch_b(B_isl), islands=serving)
    else:
        cache_b = _cache_shard_bytes(
            arch.cache_specs(shape, batch_override=B_isl,
                             dtype=torch.bfloat16), island,
            include_pod=False)
        cost = counted(lambda s: (
            build_decode(arch, cfg, groups=groups),
            (fresh_params(pdtype),
             arch.cache_specs(shape, batch_override=B_isl,
                              dtype=torch.bfloat16),
             torch.empty((B_isl, 1), dtype=torch.int32, device=META),
             S - 1)), S)
        record("serve_step", cost, param_b + cache_b + batch_b(B_isl),
               islands=serving)
    return records


# ---------------------------------------------------------------------------
# run manifest
# ---------------------------------------------------------------------------

def manifest_of(records, *, config=None) -> dict:
    """Fold dry-run records into a ``RunRecorder`` manifest: each counted
    function's wire profile (collective bytes by op, cross-pod bytes,
    stream-interleaving stats) under the ``hlo_profile`` key a live run's
    trace annotations are held against, keyed ``arch/shape/fn``."""
    rec = obs_metrics.RunRecorder(transport="dryrun",
                                  printer=lambda *_a, **_k: None)
    if config is not None:
        rec.manifest["config"] = dict(config)
    for r in records:
        if "error" in r:
            continue
        prof = {"arch": r.get("arch"), "shape": r.get("shape"),
                "mesh": r.get("mesh"), "chips": r.get("chips"),
                "collectives": r.get("collectives")}
        if "stream_interleaving" in r:
            prof["interleaving"] = r["stream_interleaving"]
        key = f"{r.get('arch')}/{r.get('shape')}/{r.get('fn', '?')}"
        rec.attach_hlo_profile(prof, fn=key)
    return rec.manifest


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="input-shape id or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fns", default="main",
                    help="comma list: main|inner|outer|ddp|stream|gossip")
    ap.add_argument("--microbatches", type=int, default=TRAIN_MICROBATCHES)
    ap.add_argument("--variant", default="",
                    help='JSON dict, e.g. {"fsdp": false}')
    ap.add_argument("--kernel-mode", default="auto",
                    help="auto: each kernel wrapper counted as one fused "
                         "leaf; ref: the plain PyTorch versions ('kernel', "
                         "'pallas' and 'interpret' are refused)")
    ap.add_argument("--stream-wire", default="float32",
                    choices=["float32", "bfloat16", "int4"],
                    help="transport precision of the --fns stream round: "
                         "quantized dtypes take the packed wire (one "
                         "coalesced all-gather a fragment)")
    ap.add_argument("--stream-tau", type=int, default=STREAM_TAU,
                    help="issue→consume window of the --fns stream round "
                         "(tau > 0 with a quantized --stream-wire defers "
                         "each consume tau inner steps)")
    ap.add_argument("--out", default="")
    ap.add_argument("--manifest", default="",
                    help="write the wire profile of each counted function "
                         "as a run manifest JSON")
    args = ap.parse_args(argv)
    variant = json.loads(args.variant) if args.variant else None
    try:
        _check_variant(variant or {}, args.kernel_mode)
    except ValueError as e:
        ap.error(str(e))

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    out = []
    t0 = time.time()
    for a in archs:
        for s in shapes:
            try:
                recs = dryrun_pair(a, s, multi_pod=args.multi_pod,
                                   microbatches=args.microbatches,
                                   fns=tuple(args.fns.split(",")),
                                   variant=variant,
                                   kernel_mode=args.kernel_mode,
                                   stream_wire=args.stream_wire,
                                   stream_tau=args.stream_tau)
            except Exception as e:     # one pair's failure is its record
                recs = [{"arch": a, "shape": s,
                         "multi_pod": args.multi_pod,
                         "error": f"{type(e).__name__}: {e}"}]
            for r in recs:
                tag = "OK" if "error" not in r else "FAIL"
                mem = r.get("memory", {})
                coll = r.get("collectives", {})
                print(f"[{tag}] {a} × {s} × "
                      f"{'multi' if args.multi_pod else 'single'} "
                      f"{r.get('fn', '')} "
                      f"flops={r.get('flops', 0):.3e} "
                      f"cross={coll.get('cross_pod_bytes', 0):.3e} "
                      f"peak/chip={mem.get('peak_bytes_est', 0):.3e} "
                      f"fits={mem.get('fits', '-')} "
                      f"bound={r.get('roofline', {}).get('bound', '-')}",
                      flush=True)
                if "error" in r:
                    print("   ", r["error"], flush=True)
                elif "stream_interleaving" in r:
                    st, ov = r["stream_interleaving"], r["stream_overlap"]
                    print(f"    stream: {st['pod_collectives']} pod syncs, "
                          f"{st['syncs_with_compute_after']} with compute "
                          f"after, {st['syncs_inside_compute']} inside; "
                          f"overlap: {ov.get('n_deferred', 0)} deferred, "
                          f"min {ov.get('min_steps_between', 0)} steps "
                          "issue->consume"
                          + (f" (tau={ov['tau']} ok={ov['ok']})"
                             if "ok" in ov else ""), flush=True)
            out.extend(recs)
    print(f"dry run: {len(out)} records, "
          f"{sum('error' in r for r in out)} failed, "
          f"{time.time() - t0:.1f} s", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(obs_metrics.to_jsonable(out), f, indent=1)
        print("wrote", args.out)
    if args.manifest:
        with open(args.manifest, "w") as f:
            json.dump(obs_metrics.to_jsonable(
                manifest_of(out, config=vars(args))), f, indent=1)
        print("wrote", args.manifest)
    return 1 if any("error" in r for r in out) else 0


if __name__ == "__main__":
    raise SystemExit(main())
