"""The dry run's island step on real ranks: one process per chip of an
island, its params, moments and batch laid out FSDP×TP as DTensors on a
(data, model) device mesh (``sharding/spec.py``), running the dry run's
own train step (``dryrun.build_train_step``). The JAX trainer runs no
within-island sharding (only its dry run lowers it), so neither does the
port's trainer: these ranks run the step to show that the sharded step
computes what the unsharded step computes, and that its collectives are
the ones the dry run counts.

    results = mesh.spawn("repro_torch.launch.island:train_steps", layout,
                         (data, model), cases)

(``serve_steps`` runs a prefill and decode steps the same way, the
cache laid out by ``cache_pspec``.)

Each case is a dict: ``cfg`` (a ``ModelConfig``), ``params``, ``v``
(AdamW's second moments the step starts from) and ``batch`` (numpy
trees: every rank holds the same full values and keeps its own block,
``spec.distribute``) or ``init_seed`` and ``tokens_shape``
(``seeded_case``: each rank draws them itself), and optionally
``microbatches`` and ``cast_outside_mb``. The step groups an MoE model's
tokens by the data axis's size (``groups``, as the dry run's island
records do, one group a data rank; capacity is per group), and the
unsharded step it is held to groups them alike. The first moments start
at 0.
On ranks that share a card (gloo, buffers staged through the host:
``launch/mesh.make_pod_layout``) every collective of the step runs on
host copies (``_HostStaged``). Every rank returns per case its
intra-island collectives as issued (``op_cost.collective_log``: (op,
bytes a chip moves)), and on a card its peak memory over the step above
what it held before its arguments, and the loss; rank 0 also returns the
params and AdamW's first moments after the step, gathered (numpy), or,
with ``check`` (a seeded case: {"atol", "rtol", "m_rel"}), every rank the
comparison of its blocks with the unsharded step of the same case, run
on its own device afterwards (``_against_unsharded``; for an MoE model
also how many of its groups' (token, k) router choices differ).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .. import convert, tree
from ..models.model import param_axes
from ..models.xlstm import shift_free
from ..models.registry import Arch
from ..sharding import spec
from . import dryrun, op_cost


def second_moments(params, gen):
    """AdamW's second moments as after earlier steps: (u / √N)² for each
    entry, u uniform in [0.5, 1.5) from ``gen`` and N the params' entries,
    the scale of a gradient whose norm is the clip's 1. From v = 0 the
    first update is lr·g/(|g| + eps), lr·sign(g) but at entries within
    eps of 0, whose sign a sum in another order flips, and blind to the
    gradient's size; from this v it is smooth in g."""
    n = sum(t.numel() for t in tree.leaves(params))
    return tree.map(lambda t: (0.5 + torch.rand(
        t.shape, generator=gen, device=t.device)).square_().div_(n), params)


def seeded_case(cfg, seed: int, tokens_shape: tuple, device):
    """(params, v, batch) drawn on ``device`` from a generator seeded
    ``seed``: ``Arch.init``'s params, uniform tokens of ``tokens_shape``,
    then ``second_moments``; every process that draws them on one device
    type gets the same values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = Arch(cfg=cfg).init(generator=gen, device=device)
    toks = torch.randint(0, cfg.vocab_size, tuple(tokens_shape),
                         generator=gen, device=device)
    return params, second_moments(params, gen), {"tokens": toks}


def sharded_args(cfg, params, v, batch, mesh):
    """(params, m, v, count, batch) of the step on ``mesh``: the params and
    ``v`` in ``param_pspec``'s layout, zero first moments like them, the
    batch over the activations' batch axes."""
    axes = param_axes(cfg)
    p = spec.shard_params(params, axes, mesh)
    ba = tuple(cfg.act_batch_axes)
    ba = ba if len(ba) > 1 else ba[0]
    b = {n: spec.distribute(x, (ba,) + (None,) * (x.dim() - 1), mesh)
         for n, x in batch.items()}
    return p, tree.map(torch.zeros_like, p), \
        spec.shard_params(v, axes, mesh), 0, b


class _HostStaged(TorchDispatchMode):
    """Every functional collective on CUDA tensors run on host copies of
    them (gloo takes CPU tensors; two ranks on one card cannot use NCCL,
    which takes one rank a card), the result copied back to the card: the
    staging the sharded transport's ranks do (``core/pod_collectives``).
    DTensor ops pass through to DTensor, whose collectives then come back
    here. DTensor's all-to-all between two shard dims runs on the host as
    DTensor runs it on a CPU mesh: an all-gather, then this rank's
    chunk."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if not op_cost._is_collective(func) or not any(
                isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return func(*args, **kwargs)
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        if func.__name__.startswith("wait_tensor"):
            return args[0]                 # completed when it was staged
        if func.namespace == "_dtensor":   # shard_dim_alltoall
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            x, gather_dim, shard_dim, group = args
            pg = _resolve_process_group(group) if isinstance(group, str) \
                else group
            n = dist.get_world_size(pg)
            c10d = torch.ops._c10d_functional
            full = c10d.wait_tensor(c10d.all_gather_into_tensor(
                x.cpu().contiguous(), n, pg.group_name))
            full = torch.cat(full.chunk(n), gather_dim)
            return full.chunk(n, shard_dim)[dist.get_rank(pg)] \
                .contiguous().to(dev)
        host = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        out = torch.ops._c10d_functional.wait_tensor(func(*host, **kwargs))
        return out.to(dev)


def train_steps(group, shape, cases) -> list:
    """Run each case's sharded train step on this rank (a pod-group
    target: ``group`` is the rank's ``PodGroup``, whose default process
    group spans the island). Returns one dict per case (see the module's
    doc)."""
    dev = group.device
    mesh = spec.island_mesh(tuple(shape), ("data", "model"), dev.type)
    out = []
    for case in cases:
        cfg = case["cfg"]
        if "init_seed" in case:
            params, v, batch = seeded_case(cfg, case["init_seed"],
                                           case["tokens_shape"], dev)
        else:
            params = convert.params_from_numpy(case["params"], device=dev)
            v = convert.params_from_numpy(case["v"], device=dev)
            batch = {n: torch.from_numpy(x).to(dev).long() if n == "tokens"
                     else torch.from_numpy(x).to(dev)
                     for n, x in case["batch"].items()}
        step = dryrun.build_train_step(
            Arch(cfg=cfg), cfg, groups=shape[0],
            microbatches=case.get("microbatches", 1),
            cast_outside_mb=case.get("cast_outside_mb", False))
        args = sharded_args(cfg, params, v, batch, mesh)
        del params, v, batch
        if dev.type == "cuda":
            # the step's peak above what the rank held before its
            # arguments (phase 34's measure; the arguments are the local
            # blocks of the params, moments and batch)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            held = sum(t.to_local().numel() * t.element_size()
                       for x in args for t in tree.leaves(x)
                       if spec.is_dtensor(t))
            base = torch.cuda.memory_allocated(dev) - held
            torch.cuda.reset_peak_memory_stats(dev)
        staged = _HostStaged() if group.staged else contextlib.nullcontext()
        # the log sees each collective as the step issues it, before it
        # is staged
        with staged, op_cost.collective_log() as log, \
                _router_choices() as picks:
            new, m, _, _, loss = step(*args)
        res = {"collectives": list(log)}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        with staged:
            loss = loss.full_tensor() if spec.is_dtensor(loss) else loss
        res["loss"] = float(loss)
        # the step wrote the params and moments in place: what it returned
        # is all that is kept (the second moments and the batch go)
        del args
        if "check" in case:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            # ranks that share a card take turns: each one's unsharded step
            # holds the whole model's state beside the others' blocks
            turns = group.pods if dev.type == "cuda" and group.staged \
                else 1
            for turn in range(turns):
                if turns == 1 or turn == group.rank:
                    res["check"] = _against_unsharded(
                        cfg, case, step, new, m, dev, picks, mesh)
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                if turns > 1:
                    dist.barrier()
        else:
            with staged:
                full = tree.map(lambda t: t.full_tensor(), new)
                full_m = tree.map(lambda t: t.full_tensor(), m)
            if group.rank == 0:
                res["params"] = convert.params_to_numpy(full)
                res["m"] = convert.params_to_numpy(full_m)
            del full, full_m
        del new, m
        out.append(res)
    return out


@contextlib.contextmanager
def _router_choices():
    """The MoE router's top-k choices ((groups, tokens, K) expert indices,
    on the host) of every ``moe._topk_iterative`` call within the block,
    in call order."""
    from ..models import moe
    picks, topk = [], moe._topk_iterative

    def spy(probs, K):
        out = topk(probs, K)
        picks.append(out[1].detach().cpu())
        return out
    moe._topk_iterative = spy
    try:
        yield picks
    finally:
        moe._topk_iterative = topk


def serve_steps(group, shape, cases) -> list:
    """A prefill and decode steps of each case on this rank's blocks (a
    pod-group target, as ``train_steps``): the params laid out by
    ``param_pspec``, the prompt and each new token over the activations'
    batch axes, the cache as ``cache_pspec`` lays it (``models.model.
    prefill`` on an island mesh), the MoE tokens grouped by the data
    axis's size. Each case: ``cfg``, ``params`` (numpy), ``tokens`` (B, S)
    the prompt, ``next`` (B, n) the tokens decoded one at a time. Returns
    per case, on rank 0, the float32 logits (numpy) of the prompt's last
    position and of each decode step, gathered; {} on the other ranks."""
    from ..models.model import decode_step, prefill
    dev = group.device
    mesh = spec.island_mesh(tuple(shape), ("data", "model"), dev.type)
    staged = _HostStaged() if group.staged else contextlib.nullcontext()
    out = []
    for case in cases:
        cfg = case["cfg"]
        params = spec.shard_params(
            convert.params_from_numpy(case["params"], device=dev),
            param_axes(cfg), mesh)
        ba = tuple(cfg.act_batch_axes)
        lay = lambda x: spec.distribute(
            torch.from_numpy(x).long().to(dev),
            (ba if len(ba) > 1 else ba[0], None), mesh)
        prompt, nxt = case["tokens"], case["next"]
        S = prompt.shape[1]
        logits = []
        with torch.no_grad(), staged, spec.on_mesh(params):
            lg, cache = prefill(params, cfg, lay(prompt),
                                cache_len=S + nxt.shape[1], groups=shape[0])
            logits.append(lg[:, -1].full_tensor().float())
            for i in range(nxt.shape[1]):
                lg, cache = decode_step(params, cfg, cache,
                                        lay(nxt[:, i:i + 1].copy()), S + i,
                                        groups=shape[0])
                logits.append(lg[:, -1].full_tensor().float())
        out.append({"logits": [x.cpu().numpy() for x in logits]}
                   if group.rank == 0 else {})
        del params, cache
    return out


def _against_unsharded(cfg, case, step, params, m, dev, picks,
                       mesh) -> dict:
    """The unsharded step of a seeded case on this rank's device, held
    against this rank's blocks of the sharded step's ``params`` and first
    moments ``m`` (nothing gathered): the unsharded loss; the largest
    differences; the param entries beyond ``case["check"]``'s (atol, rtol)
    bound; the leaves whose first moments differ by more than ``m_rel`` of
    the leaf's largest |m| (of the tree's largest for a leaf the loss does
    not depend on, ``xlstm.shift_free``: its moments are round-off), and
    the largest such ratio; and of an MoE
    model the (token, k) router choices of this rank's groups that differ
    from the unsharded step's (``picks``: the sharded step's, in call
    order; a near-tie decided otherwise by TP's reordered sums)."""
    atol, rtol, m_rel = (case["check"][k] for k in ("atol", "rtol",
                                                    "m_rel"))
    p0, v0, batch = seeded_case(cfg, case["init_seed"],
                                case["tokens_shape"], dev)
    with _router_choices() as want_picks:
        want, want_m, _, _, loss = step(p0, tree.map(torch.zeros_like, p0),
                                        v0, 0, batch)
    out = {"loss": float(loss), "entries": 0, "params_max_abs_diff": 0.0,
           "params_beyond": 0, "m_max_abs_diff": 0.0, "m_rel_max": 0.0,
           "m_leaves_beyond": 0,
           "router_choices": sum(t.numel() for t in picks),
           "router_choices_differ": _choices_differ(picks, want_picks,
                                                    mesh)}
    with torch.no_grad():
        tree_top = max(float(t.abs().max()) for t in tree.leaves(want_m))
        for (path, a), w, am, wm in zip(tree.paths(params),
                                        tree.leaves(want), tree.leaves(m),
                                        tree.leaves(want_m)):
            top = tree_top if shift_free(path) else float(wm.abs().max())
            w = spec.block_of(w, a.placements, a.device_mesh)
            wm = spec.block_of(wm, am.placements, am.device_mesh)
            a, am = a.to_local(), am.to_local()
            d, dm = (a - w).abs(), float((am - wm).abs().max())
            rel = dm / top if top > 0 else (0.0 if dm == 0 else float("inf"))
            out["entries"] += a.numel()
            out["params_max_abs_diff"] = max(out["params_max_abs_diff"],
                                             float(d.max()))
            out["params_beyond"] += int((d > atol + rtol * w.abs()).sum())
            out["m_max_abs_diff"] = max(out["m_max_abs_diff"], dm)
            out["m_rel_max"] = max(out["m_rel_max"], rel)
            out["m_leaves_beyond"] += int(rel > m_rel)
    return out


def _choices_differ(picks, want, mesh) -> int:
    """The (token, k) choices of ``picks`` (this rank's groups) that differ
    from ``want``'s at the same calls (every group; this rank's are the
    data rank's share of them, in order)."""
    if len(picks) != len(want):
        raise ValueError(f"{len(picks)} router calls against {len(want)}")
    names = list(mesh.mesh_dim_names)
    r = mesh.get_local_rank(names.index("data")) if "data" in names else 0
    n = 0
    for got, ref in zip(picks, want):
        g = got.shape[0]
        if g != ref.shape[0]:
            ref = ref[r * g:(r + 1) * g]
        n += int((got != ref).sum())
    return n
