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

Each case is a dict: ``cfg`` (a ``ModelConfig``), ``params``, ``v``
(AdamW's second moments the step starts from) and ``batch`` (numpy
trees: every rank holds the same full values and keeps its own block,
``spec.distribute``) or ``init_seed`` and ``tokens_shape``
(``seeded_case``: each rank draws them itself), and optionally
``microbatches`` and ``cast_outside_mb``. The first moments start at 0.
On ranks that share a card (gloo, buffers staged through the host:
``launch/mesh.make_pod_layout``) every collective of the step runs on
host copies (``_HostStaged``). Every rank returns per case its
intra-island collectives as issued (``op_cost.collective_log``: (op,
bytes a chip moves)), and on a card its peak memory over the step above
what it held before its arguments, and the loss; rank 0 also returns the
params and AdamW's first moments after the step, gathered (numpy), or,
with ``check`` (a seeded case: {"atol", "rtol", "m_rel"}), every rank the
comparison of its blocks with the unsharded step of the same case, run
on its own device afterwards (``_against_unsharded``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import convert, tree
from ..models.model import param_axes
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
    here."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func.namespace != "_c10d_functional" or not any(
                isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            return func(*args, **kwargs)
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        if func.__name__.startswith("wait_tensor"):
            return args[0]                 # completed when it was staged
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
            Arch(cfg=cfg), cfg, groups=1,
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
        with staged, op_cost.collective_log() as log:
            new, m, _, _, loss = step(*args)
        res = {"collectives": list(log)}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            res["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        with staged:
            loss = loss.full_tensor() if spec.is_dtensor(loss) else loss
        res["loss"] = float(loss)
        if "check" in case:
            res["check"] = _against_unsharded(cfg, case, step, new, m, dev)
        else:
            with staged:
                full = tree.map(lambda t: t.full_tensor(), new)
                full_m = tree.map(lambda t: t.full_tensor(), m)
            if group.rank == 0:
                res["params"] = convert.params_to_numpy(full)
                res["m"] = convert.params_to_numpy(full_m)
            del full, full_m
        del args, new, m
        out.append(res)
    return out


def _against_unsharded(cfg, case, step, params, m, dev) -> dict:
    """The unsharded step of a seeded case on this rank's device, held
    against this rank's blocks of the sharded step's ``params`` and first
    moments ``m`` (nothing gathered): the unsharded loss; the largest
    differences; the param entries beyond ``case["check"]``'s (atol, rtol)
    bound; the leaves whose first moments differ by more than ``m_rel`` of
    the leaf's largest |m|, and the largest such ratio."""
    atol, rtol, m_rel = (case["check"][k] for k in ("atol", "rtol",
                                                    "m_rel"))
    p0, v0, batch = seeded_case(cfg, case["init_seed"],
                                case["tokens_shape"], dev)
    want, want_m, _, _, loss = step(p0, tree.map(torch.zeros_like, p0), v0,
                                    0, batch)
    out = {"loss": float(loss), "entries": 0, "params_max_abs_diff": 0.0,
           "params_beyond": 0, "m_max_abs_diff": 0.0, "m_rel_max": 0.0,
           "m_leaves_beyond": 0}
    with torch.no_grad():
        for a, w, am, wm in zip(tree.leaves(params), tree.leaves(want),
                                tree.leaves(m), tree.leaves(want_m)):
            top = float(wm.abs().max())
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
