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
once), the collectives (per chip), ``comm_analysis.roofline`` on the
H100's rates, and the memory per chip against the card's
(``comm_analysis.memory_items``).

Within an island every family (``ISLAND_FAMILIES``) runs as JAX's GSPMD
lowering runs it, FSDP×TP on the island's (data, model) mesh: the train,
prefill and decode functions take params, moments, batch and caches as
DTensors of meta blocks laid out by the specs (``sharding/spec.py``:
``param_pspec``, ``batch_pspec``, ``cache_pspec``),
on a process group of the mesh's size on the ``fake`` backend
(``fake_world``); DTensor's propagation and the model's ``constrain``
sites put in the collectives. The record then holds one chip's
within-island collectives (``intra_pod_bytes``, by op;
``roofline.collective_intra_s`` at NVLink's rate), and its memory is the
chip's blocks of the arguments plus the peak of the chip's live storage
(``op_cost`` tracks the local blocks); its FLOPs, counted at the DTensor
ops' global shapes, are those of the same function unsharded. The
island variants (``cast_outside_mb``, ``decode_kv_shard``,
``seq_parallel``, ``no_act_shard``) apply as in JAX. Multi-pod runs keep
a ``CountingGroup`` for the pods and the same island mesh within each:
the inner step's collectives are all within the island. The elementwise
outer update and gossip exchange run none (``intra_pod_bytes`` 0); the
streaming round's inner steps are counted unsharded. The MoE tokens are
grouped by the data axis's size (``moe_groups``): JAX's three dispatch
constrain sites lay the groups over "data" and the experts over "model"
(``models/moe.py``); MLA keeps its heads over "model" and, at decode,
its latent ring's features where ``cache_pspec`` puts them. Mamba2
(zamba2) runs each rank's own heads, its ``in_proj`` and conv weights
gathered whole, B and C gathered over "model", its decode state brought
from ``cache_pspec``'s layout (N over "model") to the heads' and back at
each call (``models/ssm.py``); the tied SHARED block's weights are
gathered, and their gradient reduce-scattered, at each invocation. The
xLSTM cells (xlstm_350m) run each rank's own block of the inner width
on plain tensors, no collective inside their per-token loop
(``models/xlstm.py``): the mLSTM's value columns (q, k, i and f of the
heads the block touches), the sLSTM's whole heads (its own columns of
the pre-activations gathered over "model" once a layer where the block
is part of a head); the decode state is brought from ``cache_pspec``'s
layout to the cell's and back at each call.

What the JAX dry run has and this one does not: XLA's own cost analysis
(``xla_flops``, ``xla_bytes``). Kernel modes: ``auto`` counts each kernel
wrapper as one fused leaf (``op_cost``), ``ref`` runs the plain versions
on meta; ``kernel``, ``pallas`` and ``interpret`` are refused.

Per-token loops: the xLSTM cells step once per token (a Python loop of
~15 ops a step, 24 blocks), which would dispatch tens of millions of
ops at 4k or 32k tokens. For a family with such a loop the train and
prefill functions are counted at four short lengths (4, 8, 12, 16 tokens
for a train step, 32 to 128 for a prefill: ``FIT_STEP``) and
extrapolated to S by the quadratic through three of them, which must
give the fourth exactly (else the window moves on past a regime change,
or the pair fails): no trip multiplier is applied anywhere. On an island
the collectives are fitted too, each one's bytes: the four lengths must
issue the same collectives in the same order (a collective inside the
loop would add some with each token, and fails the pair), and under
``seq_parallel`` the lengths are multiples of the "model" axis, as S is.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from fractions import Fraction

import torch
import torch.distributed as dist

from .. import tree
from ..configs.base import SHAPES, DiLoCoConfig, ShapeConfig, TrainConfig
from ..core import diloco, gossip, pod_collectives, streaming
from ..kernels import ops as kops
from ..models import model as M
from ..models.registry import ARCH_NAMES, Arch, get_arch
from ..obs import metrics as obs_metrics
from ..optim import adamw
from ..sharding.spec import (MeshShape, batch_pspec, cache_pspec,
                             distribute, entry_axes, is_dtensor, island_mesh,
                             on_mesh, param_pspec, production_mesh,
                             shard_bytes, shard_params)
from . import comm_analysis as C
from .op_cost import counting

META = torch.device("meta")
TRAIN_MICROBATCHES = 8
STREAM_FRAGMENTS = 2
STREAM_H = 4
STREAM_ROUNDS = 2
STREAM_TAU = 0
KERNEL_MODES = ("auto", "ref")
# variants of the JAX dry run that only move the collectives within an
# island (JAX ``dryrun.py``'s hillclimbing switches)
ISLAND_ONLY_VARIANTS = ("cast_outside_mb", "decode_kv_shard",
                        "seq_parallel", "no_act_shard")
VARIANTS = ("fsdp", "pure_dp", "remat", "microbatches",
            "moe_groups") + ISLAND_ONLY_VARIANTS
# the families whose models run on an island's DTensors (FSDP×TP): all
ISLAND_FAMILIES = ("dense", "vlm", "encdec", "moe", "hybrid", "ssm")
# the mesh type the island's collectives are chosen for (the H100's; the
# DTensors hold meta blocks, so nothing runs on a card)
ISLAND_DEVICE = "cuda"


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

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


def _microbatch(x, i: int, mb: int):
    """Microbatch i of mb of batch leaf ``x``: rows i·B/mb .. of the batch
    (JAX's contiguous split ``x.reshape((mb, B // mb) + ...)``,
    ``build_train_step`` of ``src/repro/launch/dryrun.py``). Of an island's
    DTensor (rows sharded over the batch's mesh axes) the rows are gathered
    and the microbatch's rows laid out as the batch's were: the rows a
    microbatch groups matter to a loss that is not a mean over rows (the
    MoE's load-balancing term, its per-group capacity)."""
    B = x.shape[0]
    if not is_dtensor(x):
        return x[i * B // mb:(i + 1) * B // mb]
    from torch.distributed.tensor import Replicate
    mesh, pl = x.device_mesh, x.placements
    whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    sub = whole[i * B // mb:(i + 1) * B // mb]
    split = math.prod(mesh.size(a) for a, q in enumerate(pl) if q.is_shard())
    return sub.redistribute(mesh, pl) if (B // mb) % split == 0 else sub


def _like(g, a):
    """Gradient ``g`` in the layout of its accumulator ``a``, in its own
    dtype (the gradient of a hoisted, gathered weight comes back partial
    over the batch's axis: this is its FSDP reduce-scatter; the others
    are reduced in ``_CastBF16``'s backward)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(a.placements):
        return g.redistribute(a.device_mesh, a.placements)
    return g


class _CastBF16(torch.autograd.Function):
    """JAX's step casts the f32 params to bf16 and the model casts them to
    its compute dtype: a bf16 rounding of each weight, at ``dtype``. The
    gradient is brought to the param's own layout first (on an island, a
    product's partial sums are reduced where the product is, as XLA's
    partitioner reduces them, before the transpose of the casts rounds
    the sum to bf16 once), then rounded to bf16, as the transposes of
    JAX's two converts round it."""

    @staticmethod
    def forward(ctx, p, dtype):
        ctx.layout = (p.device_mesh, tuple(p.placements)) \
            if is_dtensor(p) else None
        return p.to(torch.bfloat16).to(dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.layout is not None and tuple(g.placements) != ctx.layout[1]:
            g = g.redistribute(*ctx.layout)
        return g.to(torch.bfloat16).to(torch.float32), None


def _cast_bf16(params, dtype):
    """The float leaves through ``_CastBF16`` to ``dtype``."""
    return tree.map(lambda x: _CastBF16.apply(x, dtype)
                    if x.is_floating_point() else x, params)


def _gathered(t):
    """An island leaf with its FSDP ("data") shards gathered: the weight
    every microbatch reads when the cast is hoisted."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    return t.redistribute(t.device_mesh, [
        Replicate() if n == "data" else p
        for n, p in zip(names, t.placements)])


def build_train_step(arch: Arch, cfg, *, groups: int,
                     microbatches: int = TRAIN_MICROBATCHES,
                     kernel_mode: str = "auto", group=None,
                     cast_outside_mb: bool = False):
    """(params, m, v, count, batch) -> (params, m, v, count, loss): the JAX
    dry run's step. The params are cast to bfloat16 (as JAX's step casts
    them, whatever ``cfg.compute_dtype``), and the gradients of the loss
    are accumulated in float32 over ``microbatches`` splits of the batch,
    then clipped to norm 1 and applied by the port's AdamW
    (``adamw.update``, the fused kernel under ``auto``). With ``group``
    (the DDP baseline) each accumulated gradient is all-reduced over the
    pods and divided by their count before the clip.

    On an island's DTensors (params, m, v and batch laid out by
    ``sharding/spec.py``) the same code runs FSDP×TP: each weight's
    gradient is brought to its param's layout (the FSDP reduce-scatter)
    before it is accumulated. ``cast_outside_mb`` hoists the cast, and
    with it the FSDP all-gather of every weight, out of the microbatch
    loop: the gathered bf16 weights are read by every microbatch (JAX's
    hoisted cast, which GSPMD gathers once a step)."""
    cdt = getattr(torch, cfg.compute_dtype)

    def step(params, m, v, count, batch):
        B = batch["tokens"].shape[0]
        mb = microbatches if B % microbatches == 0 else 1
        leaves = tree.leaves(params)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        losses = []
        with on_mesh(params, batch):
            if cast_outside_mb:
                hoisted = [_gathered(p.to(torch.bfloat16))
                           if p.is_floating_point() else p for p in leaves]
            for i in range(mb):
                sub = {k: _microbatch(x, i, mb) for k, x in batch.items()}
                if cast_outside_mb:
                    req = [p.detach().requires_grad_(p.is_floating_point())
                           for p in hoisted]
                    cast = tree.unflatten(params, req)
                else:
                    req = [p.detach().requires_grad_(True) for p in leaves]
                    cast = _cast_bf16(tree.unflatten(params, req), cdt)
                loss, _ = arch.loss(cast, sub, cfg=cfg, groups=groups)
                grads = torch.autograd.grad(loss, req, allow_unused=True)
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_(_like(g, a).float() / mb)
                losses.append(loss.detach())
            if group is not None:
                for a in acc:
                    group.all_reduce(a).div_(group.pods)
            grads, _ = adamw.clip_by_global_norm(
                tree.unflatten(params, acc), 1.0)
            params, st = adamw.update(grads, adamw.AdamWState(m, v, count),
                                      params, lr=4e-4, mode=kernel_mode)
            loss = torch.stack(losses).mean()
        return params, st.m, st.v, st.count, loss

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
        with on_mesh(params, batch):
            logits, cache = arch.prefill(params, batch, cfg=cfg,
                                         groups=groups)
            return logits[:, -1:], cache
    return fn


def build_decode(arch: Arch, cfg, *, groups: int):
    def fn(params, cache, tokens, pos):
        with on_mesh(params, cache, tokens):
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


# how many times the per-token fit's window of four lengths may move on
FIT_SHIFTS = 4


def _extrapolated(count_at, S: int, step: int) -> dict:
    """Counts at S from four short lengths, ``step`` × (1, 2, 3, 4): each
    count is fitted by the quadratic through the first three and checked
    on the fourth (exactly), then evaluated at S; a count that is no such
    polynomial of the length fails the pair. (FLOPs and bytes are affine
    in the length, and an affine count is a quadratic too; the peak live
    bytes of a short run are the largest of several such counts, so they
    can change regime as the length grows.) Where a count changes regime
    among the first lengths (xlstm_350m ``train_4k`` at one microbatch:
    its peak live bytes settle on their asymptote at 20 tokens), the
    window of four lengths moves on by one step, at most ``FIT_SHIFTS``
    times, and the fit is taken from the first window that passes its
    check. An island count's collectives are fitted alike, each one's
    bytes (``_series``)."""
    got = {}
    for start in range(1, FIT_SHIFTS + 2):
        lens = [step * i for i in range(start, start + 4)]
        for s in lens:
            if s not in got:
                got[s] = count_at(s)
        series = _series([got[s] for s in lens])
        bad = [key for key, ys in series.items()
               if ys is None or _quadratic_at(lens, ys, lens[3]) != ys[3]]
        if not bad:
            break
    else:
        key = bad[0]
        raise ValueError(
            f"{key} is not a quadratic in the length "
            f"({[(s, _series([got[s]]).get(key)) for s in sorted(got)]}): "
            "cannot extrapolate")
    at = {key: int(round(_quadratic_at(lens, ys, S)))
          for key, ys in series.items()}
    # the live set's peak holds at least what is live at its end: a peak
    # fitted where constant terms lead (an island's gathered weights, at a
    # few tokens a chip) is raised to the fitted end, the outputs that
    # grow with the length (a prefill's logits)
    at["peak_live_bytes"] = max(at["peak_live_bytes"], at["end_live_bytes"])
    out = dict(got[lens[0]])
    out.update({key: at[key] for key in _COUNTS})
    if "collectives" in out:
        out["collectives"] = [(op, at[f"collective {i} {op}"]) for i, (op, _)
                              in enumerate(out["collectives"])]
    out["extrapolated_from"] = lens
    return out


def _series(costs) -> dict:
    """The numbers of counts at several lengths that the fit extrapolates,
    each as the list of its values: ``_COUNTS``, and each collective's
    bytes (keyed "collective i op"). Where the counts' collectives differ
    in their ops (a collective inside a per-token loop adds some with
    each token) the key "collective ops" holds None."""
    out = {key: [c[key] for c in costs] for key in _COUNTS}
    ops = [[op for op, _ in c.get("collectives", ())] for c in costs]
    if any(o != ops[0] for o in ops):
        out["collective ops"] = None
        return out
    for i, op in enumerate(ops[0]):
        out[f"collective {i} {op}"] = [c["collectives"][i][1] for c in costs]
    return out


def _check_variant(variant: dict, kernel_mode: str):
    """Refuse an unknown variant or kernel mode."""
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(
            f"kernel_mode={kernel_mode!r}: the dry run takes {KERNEL_MODES} "
            "('kernel' needs CUDA tensors; 'pallas' and 'interpret' name "
            "TPU machinery the port has no counterpart of)")
    for key in variant:
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


def _add_intra(stats: C.CollectiveStats, collectives) -> C.CollectiveStats:
    """``stats`` plus a chip's within-island collectives ((op, bytes), as
    ``op_cost`` records them): intra-pod bytes, by op."""
    for op, nb in collectives:
        stats.total_bytes += nb
        stats.intra_pod_bytes += nb
        stats.count += 1
        stats.by_op[op] = stats.by_op.get(op, 0) + nb
    return stats


@contextlib.contextmanager
def fake_world(n: int):
    """A default process group of ``n`` ranks on the ``fake`` backend
    (this process rank 0; collectives return at once and move nothing),
    for an island's DTensors of meta blocks. Refused where a real group is
    up; removed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run's island counts make their own "
                           "fake process group: a process group is up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def island_step_cost(cfg, batch: int, seq: int, shape: tuple) -> dict:
    """``op_cost`` of one island train step (``build_train_step``, one
    microbatch, the MoE tokens grouped by the data axis's size) of the
    model ``cfg`` on a (data, model) mesh of ``shape``,
    on meta blocks at ``batch`` × ``seq`` tokens: the counts one chip of
    the island makes (its collectives, its live storage), laid out as
    ``launch/island.py`` lays out a real run. Its ``argument_bytes`` are
    the chip's blocks of the params, moments and batch."""
    from ..models.model import init_params, param_axes
    arch = Arch(cfg=cfg)
    with fake_world(math.prod(shape)):
        mesh = island_mesh(tuple(shape), ("data", "model"), ISLAND_DEVICE)
        params = shard_params(init_params(cfg, generator=None, device=META),
                              param_axes(cfg), mesh)
        ba = tuple(cfg.act_batch_axes)
        tokens = distribute(torch.empty((batch, seq), dtype=torch.int64,
                                        device=META),
                            (ba if len(ba) > 1 else ba[0], None), mesh)
        args = (params, tree.map(torch.zeros_like, params),
                tree.map(torch.zeros_like, params), 0, {"tokens": tokens})
        held = sum(t.to_local().numel() * t.element_size()
                   for x in args for t in tree.leaves(x) if is_dtensor(t))
        cost = _count(build_train_step(arch, cfg, groups=shape[0],
                                       microbatches=1), args)
    cost["argument_bytes"] = held
    return cost


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
      cast_outside_mb: bool — hoist the bf16 cast, and with it the FSDP
                            all-gather, out of the microbatch loop
      decode_kv_shard: str — constrain decode scores' kv dim to this axis
      seq_parallel: bool  — residual stream over (batch, seq on "model")
      no_act_shard: bool  — residual stream's d_model not sharded
    The last four steer within-island collectives.
    """
    variant = dict(variant or {})
    arch = get_arch(arch_name)
    _check_variant(variant, kernel_mode)
    island_sharded = arch.cfg.family in ISLAND_FAMILIES
    with (fake_world(_island_of(mesh, multi_pod).devices) if island_sharded
          else contextlib.nullcontext()):
        return _dryrun_pair(arch, arch_name, shape_name,
                            multi_pod=multi_pod, microbatches=microbatches,
                            fns=fns, mesh=mesh, variant=variant,
                            kernel_mode=kernel_mode,
                            stream_wire=stream_wire, stream_tau=stream_tau,
                            island_sharded=island_sharded)


def _island_of(mesh, multi_pod) -> MeshShape:
    mesh = mesh or production_mesh(multi_pod=multi_pod)
    sizes = mesh.sizes
    return MeshShape(tuple(a for a in mesh.axis_names if a != "pod"),
                     tuple(n for a, n in sizes.items() if a != "pod"))


def _dryrun_pair(arch, arch_name, shape_name, *, multi_pod, microbatches,
                 fns, mesh, variant, kernel_mode, stream_wire, stream_tau,
                 island_sharded) -> list[dict]:
    microbatches = int(variant.get("microbatches", microbatches))
    t0 = time.time()
    shape = SHAPES[shape_name]
    cfg = arch.shape_cfg(shape)
    train = shape.kind == "train"
    # training: f32 master params, bf16 compute; serving: bf16 params
    cfg = cfg.replace(compute_dtype="bfloat16",
                      param_dtype="float32" if train else "bfloat16")
    if "remat" in variant:
        cfg = cfg.replace(remat=bool(variant["remat"]))
    if "decode_kv_shard" in variant:
        cfg = cfg.replace(decode_kv_shard=variant["decode_kv_shard"])
    if variant.get("seq_parallel"):
        cfg = cfg.replace(act_seq_shard=True, act_model_shard=False)
    if variant.get("no_act_shard"):
        cfg = cfg.replace(act_model_shard=False)
    fsdp = bool(variant.get("fsdp", True))
    cast_outside_mb = bool(variant.get("cast_outside_mb", False))
    pure_dp = bool(variant.get("pure_dp", False))
    mesh = mesh or production_mesh(multi_pod=multi_pod)
    chips = mesh.devices
    sizes = mesh.sizes
    pods = sizes.get("pod", 1)
    island = _island_of(mesh, multi_pod)
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
    if pure_dp:
        # small-model regime: batch over every axis, params replicated, no
        # Megatron activation sharding (as JAX's pure_dp)
        cfg = cfg.replace(act_batch_axes=entry_axes(batch_axes) or
                          ("data",), act_model_shard=False)
    shards = math.prod(sizes[a] for a in entry_axes(batch_axes))
    param_b = _tree_shard_bytes(pshapes, paxes, island, fsdp=fsdp,
                                pure_dp=pure_dp)
    batch_b = lambda B: sum(
        -(-B // shards) * math.prod(v.shape[1:]) * v.element_size()
        for v in in_specs.values())

    # the island's device mesh: params, moments, batch and caches as
    # DTensors of meta blocks laid out by the specs
    dmesh = island_mesh(island.shape, island.axis_names, ISLAND_DEVICE) \
        if island_sharded else None

    def on_island(params):
        if dmesh is None:
            return params
        return shard_params(params, paxes, dmesh, fsdp=fsdp,
                            pure_dp=pure_dp)

    def batch_on_island(batch):
        if dmesh is None:
            return batch
        return {n: distribute(x, (batch_axes,) + (None,) * (x.dim() - 1),
                              dmesh) for n, x in batch.items()}

    def cache_on_island(cache):
        if dmesh is None:
            return cache
        return tree.map_nested(lambda t: distribute(
            t, cache_pspec(tuple(t.shape), island, include_pod=False)
            if t.is_floating_point() else (None,) * t.dim(), dmesh), cache)

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
        return batch_on_island(arch.input_specs(
            ShapeConfig(shape.name, S, B, shape.kind), dtype=torch.bfloat16))

    def record(name, cost, arg_bytes, *, islands, group=None,
               temp_shards=None, intra=None):
        """One function's record from one island's ``cost``; ``islands``:
        how many islands run it (its global totals). On the island's
        DTensors the cost's live storage is one chip's and its
        collectives are the chip's within the island; otherwise the
        temporaries are divided by the batch's shards, or by
        ``temp_shards`` (a function without a batch: its param-shaped
        temporaries spread over the island), and ``intra`` says what the
        record holds of within-island collectives: 0 (the function runs
        none: elementwise on each chip's shards) or a reason they are not
        modelled."""
        stats = C.CollectiveStats() if group is None \
            else _per_chip(group.stats, cpp)
        sharded = dmesh is not None and intra is None
        if sharded:
            _add_intra(stats, cost["collectives"])
        flops = cost["flops"] * islands
        nbytes = cost["bytes"] * islands
        nbytes_min = cost["bytes_min"] * islands
        terms = C.roofline(flops, nbytes, stats, chips=chips)
        terms["memory_min_s"] = nbytes_min / (chips * C.HBM_BW)
        terms["model_flops_ratio"] = mf / flops if flops else 0.0
        coll = stats.as_dict()
        if not sharded and intra != 0:
            # the stats hold no within-island bytes: not modelled, not 0
            terms["collective_intra_s"] = None
            coll["intra_pod_bytes"] = None
            coll["intra_pod"] = intra or ("within-island collectives are "
                                          "not modelled: counted without "
                                          "an island mesh")
        if group is not None:
            coll["per_rank"] = group.stats.as_dict()
            coll["traffic"] = dict(group.traffic)
        rec = {"fn": name, "flops": flops, "hbm_bytes": nbytes,
               "hbm_bytes_min": nbytes_min, "dots": cost["dots"] * islands,
               "fused_leaves_per_island": cost["leaves"],
               "collectives": coll, "roofline": terms,
               "memory": C.memory_items(
                   arg_bytes, cost,
                   batch_shards=1 if sharded else temp_shards or shards),
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
            step = FIT_STEP[shape.kind]
            if cfg.act_seq_shard and dmesh is not None:
                step = math.lcm(step, sizes.get("model", 1))
            return _extrapolated(at, S, step)
        return at(S)

    def fresh_params(dtype=torch.float32):
        return _meta_params(arch, cfg, dtype)[0]

    def band(p):                  # this rank's (1, ...) replica band
        return tree.map(lambda t: torch.empty((1,) + tuple(t.shape),
                                              device=META), p)

    # functions that run no within-island collective (elementwise on each
    # chip's shards) and the streaming round (its inner steps are counted
    # unsharded)
    elementwise = 0 if island_sharded else None
    stream_why = ("within-island collectives of the streaming round are "
                  "not modelled: its inner steps are counted unsharded "
                  "within an island") if island_sharded else None
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
                p = on_island(fresh_params())
                group = None
                if made is not None:
                    group = C.CountingGroup(0, pods)
                    made.append(group)
                fn = build_train_step(arch, cfg, groups=groups,
                                      microbatches=microbatches,
                                      kernel_mode=kernel_mode, group=group,
                                      cast_outside_mb=cast_outside_mb)
                return fn, (p, tree.map(torch.zeros_like, p),
                            tree.map(torch.zeros_like, p), 0, batch_of(B, s))
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
                       islands=1, group=g, temp_shards=no_batch,
                       intra=elementwise)
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
                             islands=pods, group=g, intra=stream_why)
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
                       group=g, temp_shards=no_batch, intra=elementwise)
            if "main" in fns or "ddp" in fns:
                made = []
                cost = counted(step(B_isl, made), S)
                record("ddp_train_step", cost, state_b(B_isl),
                       islands=pods, group=made[-1])
    elif shape.kind == "prefill":
        cost = counted(lambda s: (build_prefill(arch, cfg, groups=groups),
                                  (on_island(fresh_params(pdtype)),
                                   batch_of(B_isl, s))), S)
        record("prefill", cost, param_b + batch_b(B_isl), islands=serving)
    else:
        cache_b = _cache_shard_bytes(
            arch.cache_specs(shape, batch_override=B_isl,
                             dtype=torch.bfloat16), island,
            include_pod=False)
        tokens = torch.empty((B_isl, 1), dtype=torch.int32, device=META)
        cost = counted(lambda s: (
            build_decode(arch, cfg, groups=groups),
            (on_island(fresh_params(pdtype)),
             cache_on_island(arch.cache_specs(shape, batch_override=B_isl,
                                              dtype=torch.bfloat16)),
             batch_on_island({"tokens": tokens})["tokens"], S - 1)), S)
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
