"""DiLoCo (Algorithm 1): Distributed Low-Communication training, as in
the JAX ``core/diloco.py``, on the synchronous simulated transport.

  * inner — every replica independently runs H steps of AdamW on its own
    data shard;
  * outer — every H steps the per-replica deltas Δ_i = θ^(t-1) − θ_i^(t)
    are averaged and applied by an outer optimizer (Nesterov by default)
    to the global copy, which is then re-dispatched.

The k replicas are kept stacked on a leading (k, ...) dim of every
parameter and AdamW leaf, as in the JAX package. Where JAX ``vmap``s the
inner step over that dim and ``scan``s it over H, the port loops over
replicas and steps in Python and updates each replica's slice of the
stacked state in place (the counterpart of the JAX driver's donation).
An inactive replica (adaptive compute pool) takes no step: its params
and AdamW state stay as they were, as the JAX ``jnp.where`` leaves them,
and only its loss on its batches is evaluated (a forward pass), as the
JAX round reports it in ``inner_loss``.

Step counters (AdamW counts, the outer count, ``outer_t``,
``inner_steps_done``) are host integers: the schedule and the bias
corrections are computed on the host from them, so no step waits on the
device. Masks and weights are host (k,) arrays.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import tree
from ..configs.base import DiLoCoConfig, TrainConfig
from ..optim import adamw, precision
from ..optim.schedule import make_warmup_cosine
from . import compression, outer_opt


class DiLoCoState(NamedTuple):
    """Carried across rounds. replica_* leaves have a leading (k,) dim;
    ``inner_state.count`` is a (k,) int32 numpy array.

    Under a mixed precision policy ``replica_params`` and the inner m/v
    moments ride at ``param_dtype`` (bfloat16) and ``inner_state.master``
    carries the per-replica float32 master copies; ``global_params`` and
    the outer state stay float32 under every policy."""
    global_params: Any            # θ^(t-1), the shared copy
    outer_state: outer_opt.OuterState
    replica_params: Any           # (k, ...) per-replica θ_i
    inner_state: adamw.AdamWState
    outer_t: int                  # outer step counter t
    inner_steps_done: int         # shared schedule position


def init_state(params, dcfg: DiLoCoConfig) -> DiLoCoState:
    """Start DiLoCo from ``params`` (float32); every leaf is copied. The
    replicas are cast to the policy's ``param_dtype`` and their moments
    allocated at it; under a mixed policy each replica also carries a
    float32 master copy."""
    pol = precision.policy_of(dcfg)
    k = dcfg.k
    rep = tree.map(lambda p: p.unsqueeze(0).expand(k, *p.shape).clone(),
                   params)
    zeros = lambda p: torch.zeros_like(p, dtype=pol.param_dtype)
    return DiLoCoState(
        global_params=tree.map(torch.clone, params),
        outer_state=outer_opt.init(params),
        replica_params=precision.cast_tree(rep, pol.param_dtype),
        inner_state=adamw.AdamWState(
            m=tree.map(zeros, rep), v=tree.map(zeros, rep),
            count=np.zeros((k,), np.int32),
            # the stacked copies are fresh: they become the masters as they
            # are (cast_tree copies them to the narrower working dtype)
            master=rep if pol.mixed else None),
        outer_t=0,
        inner_steps_done=0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# inner optimization (lines 4-9)
# ---------------------------------------------------------------------------

def make_inner_step(loss_fn: Callable, tcfg: TrainConfig,
                    total_steps: int | None = None):
    """One AdamW step for ONE replica. loss_fn(params, batch) ->
    (loss, metrics). Returns step(params, opt_state, batch, step_idx),
    which updates ``params`` and the moments in place; with
    ``frozen=True`` it only evaluates the loss (forward only) and leaves
    both as they are."""
    sched = make_warmup_cosine(tcfg.inner_lr, tcfg.warmup_steps,
                               total_steps or tcfg.total_steps)
    pol = precision.policy_of(tcfg)

    def step(params, opt_state, batch, step_idx: int, *,
             frozen: bool = False):
        lr = sched(step_idx)
        if frozen:          # the loss of ``params`` only, no update
            with torch.no_grad():
                loss, _ = loss_fn(params, batch)
            nan = torch.full((), float("nan"), device=loss.device)
            return params, opt_state, {"loss": loss.float(), "gnorm": nan,
                                       "lr": float(lr)}
        req = tree.map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = loss_fn(req, batch)
        leaves = tree.leaves(req)
        # a leaf the loss never reads (the parallel block's ln2) has a
        # zero gradient, as under jax.grad
        grads = tree.unflatten(params, [
            torch.zeros_like(t) if g is None else g for t, g in zip(
                leaves, torch.autograd.grad(loss, leaves,
                                            allow_unused=True))])
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = adamw.update(
            grads, opt_state, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            eps=tcfg.eps, weight_decay=tcfg.weight_decay,
            mode=tcfg.kernel_mode, policy=pol)
        return params, opt_state, {"loss": loss.detach().float(),
                                   "gnorm": gnorm, "lr": float(lr)}

    return step


def inner_phase(inner_step, replica_params, inner_state, batches, step0,
                *, active_mask=None):
    """H inner steps for all k replicas, in place on the stacked state.

    batches: {"tokens": (k, H, B, S)}; step0: host index of the phase's
    first inner step (shared lr schedule). ``active_mask`` (k,): inactive
    replicas take no step and keep their params and AdamW state; their
    losses are those of their frozen params on their own batches (forward
    only), as in the JAX package.
    Returns (replica_params, inner_state, metrics) with "loss" and
    "gnorm" (k, H) tensors ("gnorm" NaN where a replica was inactive).
    """
    k = tree.leaves(replica_params)[0].shape[0]
    H = batches["tokens"].shape[1]
    active = (np.ones((k,), np.float32) if active_mask is None
              else np.asarray(active_mask, np.float32))
    counts = np.array(inner_state.count, np.int32)
    losses, gnorms, lrs = [], [], []
    for i in range(k):
        frozen = bool(active[i] <= 0)
        p = tree.map(lambda a: a[i], replica_params)
        s = adamw.AdamWState(
            tree.map(lambda a: a[i], inner_state.m),
            tree.map(lambda a: a[i], inner_state.v), int(counts[i]),
            None if inner_state.master is None
            else tree.map(lambda a: a[i], inner_state.master))
        li, gi = [], []
        for h in range(H):
            batch = {name: b[i, h] for name, b in batches.items()}
            p, s, m = inner_step(p, s, batch, step0 + h, frozen=frozen)
            li.append(m["loss"])
            gi.append(m["gnorm"])
            if len(lrs) < H:
                lrs.append(m["lr"])
        counts[i] = s.count
        losses.append(li)
        gnorms.append(gi)
    stack = lambda rows: torch.stack([torch.stack(r) for r in rows])
    new_inner = inner_state._replace(count=counts)
    return replica_params, new_inner, {"loss": stack(losses),
                                       "gnorm": stack(gnorms), "lr": lrs}


# ---------------------------------------------------------------------------
# outer optimization (lines 11-14)
# ---------------------------------------------------------------------------

def outer_step(state: DiLoCoState, dcfg: DiLoCoConfig, *, drop_mask=None,
               active_mask=None, weights=None,
               compute_cosine: bool = False, bomb_mask=None):
    """Average outer gradients and update the global copy (in place).

    drop_mask (k,): 1 = outer grad communicated, 0 = dropped (the replica
    keeps its own params for the next phase — Fig 8). active_mask (k,):
    0 = replica not in the pool this round. weights (k,): shard-size
    weights (uniform if None). bomb_mask (k,), fault injection: 1 poisons
    the replica's delta to NaN before the pruning, the guard and the
    reduce (``faults.Scenario.nan_masks`` rows; a corrupted-gradient
    stand-in the guard must catch). With ``dcfg.prune_frac > 0`` each
    replica's delta is sign-pruned (Table 6) before the guard and the
    reduce, and ``metrics["prune_density"]`` is the share of its entries
    kept. Returns (new_state, metrics).
    """
    k = dcfg.k
    ones = np.ones((k,), np.float32)
    drop = ones if drop_mask is None else np.asarray(drop_mask, np.float32)
    act = ones if active_mask is None else np.asarray(active_mask,
                                                      np.float32)
    w = ones if weights is None else np.asarray(weights, np.float32)
    gp = state.global_params
    dev = tree.leaves(gp)[0].device
    m = torch.from_numpy(drop * act * w).to(dev)              # (k,)

    # Δ_i = θ^(t-1) − θ_i^(t)   (line 12). Under a mixed policy the
    # deltas are taken master against master, in float32; bf16 replicas
    # (the pure policy) are widened to float32 exactly.
    masters = state.inner_state.master
    deltas = tree.map(lambda g, r: g[None] - r, gp,
                      state.replica_params if masters is None else masters)
    if bomb_mask is not None:
        for i in np.flatnonzero(np.asarray(bomb_mask) > 0):
            for d in tree.leaves(deltas):
                d[i] = float("nan")
    prune_metrics = {}
    if dcfg.prune_frac > 0:
        # the k replicas' rows stacked: one pruning per leaf
        compression.sign_prune(deltas, dcfg.prune_frac,
                               mode=dcfg.kernel_mode, stacked=True)
        prune_metrics["prune_density"] = compression.density(deltas)

    guard_metrics = {}
    if dcfg.guard_outer:
        # a replica whose delta has any non-finite value is excluded
        # from the reduce and its values zeroed (exact identities on
        # finite rounds)
        fin = torch.stack([torch.isfinite(d.reshape(k, -1)).all(dim=1)
                           for d in tree.leaves(deltas)]).all(dim=0)
        ok = fin.float()
        deltas = tree.map(lambda d: torch.where(torch.isfinite(d), d,
                                                torch.zeros_like(d)),
                          deltas)
        m = m * ok
        guard_metrics["guard_rejected"] = (1.0 - ok).sum()
        if dcfg.guard_clip > 0:
            norms = torch.sqrt(sum(torch.sum(torch.square(d.reshape(k, -1)),
                                             dim=1)
                                   for d in tree.leaves(deltas)))
            live = np.where(ok.cpu().numpy() > 0, norms.cpu().numpy(),
                            np.nan)
            med = (np.float32(np.nanmedian(live))
                   if np.isfinite(live).any() else np.float32(0.0))
            ceil = np.float32(dcfg.guard_clip) * med
            ceil_t = torch.full_like(norms, float(ceil))
            scale = torch.where(norms > ceil_t,
                                ceil_t / torch.clamp(norms, min=1e-30),
                                torch.ones_like(norms))
            deltas = tree.map(
                lambda d: d * scale.reshape((k,) + (1,) * (d.dim() - 1)),
                deltas)
            guard_metrics["guard_clipped"] = (scale < 1.0).sum().float()
    denom = torch.clamp(m.sum(), min=1e-9)

    # weighted average over communicating replicas (the all-reduce)
    def reduce(d):
        acc = m[0] * d[0]
        for i in range(1, k):
            acc = acc + m[i] * d[i]
        return acc / denom

    avg = tree.map(reduce, deltas)
    new_global, new_outer = outer_opt.update(
        avg, state.outer_state, gp, kind=dcfg.outer_opt, lr=dcfg.outer_lr,
        momentum=dcfg.outer_momentum, b2=dcfg.outer_adam_b2,
        eps=dcfg.outer_adam_eps, kernel_mode=dcfg.kernel_mode)

    # re-dispatch: communicated & active replicas adopt θ^(t); dropped
    # replicas continue from their own θ_i; inactive replicas park on θ^(t).
    # copy_ rounds θ^(t) to the replicas' dtype; masters adopt it as it is.
    adopt = np.maximum(drop, 1.0 - act)
    targets = [state.replica_params] + ([] if masters is None
                                        else [masters])
    with torch.no_grad():
        for i in range(k):
            if adopt[i] > 0:
                for dst in targets:
                    for g, r in zip(tree.leaves(new_global),
                                    tree.leaves(dst)):
                        r[i].copy_(g)

    metrics = {"outer_gnorm": _tree_norm(avg),
               "drop_frac": float(np.float32(1.0) - drop.mean()),
               **prune_metrics, **guard_metrics}
    if compute_cosine:
        metrics["cos_mean"], metrics["cos_std"] = _pairwise_cosine(deltas, m)
    return state._replace(global_params=new_global, outer_state=new_outer,
                          outer_t=state.outer_t + 1), metrics


def _tree_norm(t):
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree.leaves(t)))


def _pairwise_cosine(deltas, mask):
    """Mean/std of pairwise cosine similarity between replicas' outer
    gradients (Fig 10/11). deltas: tree of (k, ...) leaves."""
    flat = torch.cat([d.reshape(d.shape[0], -1).float()
                      for d in tree.leaves(deltas)], dim=1)   # (k, P)
    norm = torch.linalg.norm(flat, dim=1, keepdim=True)
    unit = flat / torch.clamp(norm, min=1e-12)
    sim = unit @ unit.T
    k = flat.shape[0]
    pair = mask[:, None] * mask[None, :] * (1 - torch.eye(k,
                                                          device=flat.device))
    denom = torch.clamp(pair.sum(), min=1e-9)
    mean = (sim * pair).sum() / denom
    var = (torch.square(sim - mean) * pair).sum() / denom
    return mean, torch.sqrt(var)


# ---------------------------------------------------------------------------
# round driver (one outer iteration = H inner steps + outer step)
# ---------------------------------------------------------------------------

def _check_ported(dcfg: DiLoCoConfig, tcfg: TrainConfig):
    if precision.policy_of(dcfg) != precision.policy_of(tcfg):
        raise ValueError(
            "DiLoCoConfig and TrainConfig precision policies disagree: "
            f"dcfg=({dcfg.param_dtype}, {dcfg.master_dtype}) vs "
            f"tcfg=({tcfg.param_dtype}, {tcfg.master_dtype}); the state "
            "layout (dcfg) must match the inner step (tcfg)")


def make_round(loss_fn, sample_fn, dcfg: DiLoCoConfig, tcfg: TrainConfig,
               *, total_steps: int | None = None,
               compute_cosine: bool = False, batch_size: int | None = None,
               seq_len: int | None = None, group=None, nan_bombs=None):
    """Build the DiLoCo round.

    sample_fn(gen, batch, seq_len) -> (k', batch, S) tokens, one batch per
    shard; the round draws all H steps' batches in one call (batch H·B).
    Returns round(state, gen, drop_mask, active_mask, weights) ->
    (state, metrics). The state is updated in place and returned.
    Metrics hold device scalars plus the host seconds the round spent
    sampling (``sample_s``), in the inner phase (``inner_s``) and in the
    outer step (``outer_s``), each closed by a device synchronize.
    ``dcfg.streaming_fragments >= 1`` builds the streaming round
    (``core/streaming.py``), whose state is a ``streaming.StreamState``;
    ``dcfg.transport == "sharded"`` runs it on this rank's pod ``group``
    (``launch/mesh.py``); ``dcfg.transport == "gossip"`` builds the gossip
    round (``core/gossip.py``), whose state is a ``gossip.GossipState``
    and which refuses a ``group``. ``nan_bombs`` ((rounds, k) mask, the classic
    simulated round only) poisons the outer deltas of the masked (round,
    replica) cells (``outer_step``'s ``bomb_mask``), its rows indexed by
    the state's own ``outer_t``, so that a resumed run finds its place in
    the schedule.
    """
    if nan_bombs is not None and (dcfg.transport != "simulated"
                                  or dcfg.streaming_fragments):
        raise ValueError(
            "nan_bombs poison the classic outer reduce "
            "(transport='simulated', streaming_fragments=0); other "
            "transports would silently ignore the injection")
    if dcfg.transport == "async":
        raise ValueError(
            "transport='async' is barrier-free — there is no round to "
            "build: drive it with core.async_diloco.AsyncEngine (or "
            "run_async) and a faults.Scenario")
    _check_ported(dcfg, tcfg)
    if dcfg.transport == "gossip":
        # gossip reuses streaming_fragments as its partial-averaging
        # schedule, so it is routed before the streaming round
        from . import gossip
        return gossip.make_gossip_round_body(
            loss_fn, sample_fn, dcfg, tcfg, total_steps=total_steps,
            compute_cosine=compute_cosine, batch_size=batch_size,
            seq_len=seq_len, group=group)
    if dcfg.transport not in ("simulated", "sharded"):
        raise ValueError(f"unknown transport {dcfg.transport!r}")
    if dcfg.streaming_fragments:
        from . import streaming
        return streaming.make_stream_round_body(
            loss_fn, sample_fn, dcfg, tcfg, total_steps=total_steps,
            compute_cosine=compute_cosine, batch_size=batch_size,
            seq_len=seq_len, group=group)
    if dcfg.transport != "simulated":
        raise ValueError(
            "transport='sharded' is a streaming-path feature: set "
            "streaming_fragments >= 1")
    if dcfg.outer_grad_dtype != "float32":
        raise NotImplementedError(
            f"outer_grad_dtype={dcfg.outer_grad_dtype!r} rides the "
            "streaming round: set streaming_fragments >= 1 (the classic "
            "outer step ships float32 outer gradients)")
    inner_step = make_inner_step(loss_fn, tcfg, total_steps)
    B = batch_size or tcfg.batch_size
    S = seq_len or tcfg.seq_len
    bombs = None if nan_bombs is None else np.asarray(nan_bombs, np.float32)

    def round_body(state: DiLoCoState, gen, drop_mask=None,
                   active_mask=None, weights=None):
        H, k = dcfg.H, dcfg.k
        dev = tree.leaves(state.global_params)[0].device
        t0 = time.perf_counter()
        toks = sample_fn(gen, H * B, S)[:k].reshape(k, H, B, S)
        _sync(dev)
        t1 = time.perf_counter()
        rp, is_, ms = inner_phase(
            inner_step, state.replica_params, state.inner_state,
            {"tokens": toks}, state.inner_steps_done,
            active_mask=active_mask)
        state = state._replace(replica_params=rp, inner_state=is_,
                               inner_steps_done=state.inner_steps_done + H)
        _sync(dev)
        t2 = time.perf_counter()
        bomb = None if bombs is None else \
            bombs[min(state.outer_t, len(bombs) - 1)]
        state, om = outer_step(state, dcfg, drop_mask=drop_mask,
                               active_mask=active_mask, weights=weights,
                               compute_cosine=compute_cosine,
                               bomb_mask=bomb)
        _sync(dev)
        om["inner_loss"] = ms["loss"].mean()
        om["inner_loss_last"] = ms["loss"][:, -1].mean()
        om.update(sample_s=t1 - t0, inner_s=t2 - t1,
                  outer_s=time.perf_counter() - t2)
        return state, om

    return round_body


def make_run(loss_fn, sample_fn, dcfg: DiLoCoConfig, tcfg: TrainConfig,
             *, rounds_per_call: int, total_steps: int | None = None,
             compute_cosine: bool = False, batch_size: int | None = None,
             seq_len: int | None = None, eval_tokens=None,
             eval_every: int = 1, donate: bool = True, group=None,
             nan_bombs=None):
    """Build the multi-round driver (the JAX ``make_run``): R =
    ``rounds_per_call`` rounds of ``make_round``'s round body per call,
    every metric returned stacked along a leading (R,) dim.

    Returns ``run(state, gen, drop_masks, active_masks, weights,
    round_offset=0) -> (state, metrics)``; drop and active masks are (R,
    k) arrays (or None for all ones). The rounds draw from ``gen`` in
    place, so one ``run`` call is bit-identical to R ``make_round`` calls
    on the same generator (the JAX ``split_chain``/``next_key`` chain has
    no counterpart: the generator's state is the carry).

    ``eval_tokens`` (B, S) enables the periodic eval: the rounds whose
    global index ``round_offset + t + 1`` divides by ``eval_every``, and
    the last round of the call, report ``val_loss`` (a device scalar, the
    global params' loss); the others report NaN and pay no eval. Chunked
    callers pass ``round_offset`` = rounds already done so that the
    cadence stays aligned across calls.

    Metrics stay on the device (tensors stacked on it; the host floats as
    numpy arrays) until the caller copies them
    (``RunRecorder.ingest_chunk``): the call adds no host sync of its
    own. ``donate`` is accepted and ignored: the port's state is already
    updated in place.
    """
    del donate
    round_body = make_round(
        loss_fn, sample_fn, dcfg, tcfg, total_steps=total_steps,
        compute_cosine=compute_cosine, batch_size=batch_size,
        seq_len=seq_len, group=group, nan_bombs=nan_bombs)
    R = int(rounds_per_call)
    ev = make_eval(loss_fn)

    def run_fn(state, gen, drop_masks=None, active_masks=None,
               weights=None, round_offset: int = 0):
        per_round = []
        for t in range(R):
            state, m = round_body(
                state, gen, None if drop_masks is None else drop_masks[t],
                None if active_masks is None else active_masks[t], weights)
            if eval_tokens is not None:
                gp = state.global_params
                if (round_offset + t + 1) % eval_every == 0 or t == R - 1:
                    m["val_loss"] = ev(gp, eval_tokens).float()
                else:
                    m["val_loss"] = torch.full(
                        (), float("nan"), device=tree.leaves(gp)[0].device)
            per_round.append(m)
        return state, {k: _stack([m[k] for m in per_round])
                       for k in per_round[0]}

    return run_fn


def _stack(values: list):
    """R rounds' values of one metric: device scalars stacked on their
    device, host numbers as a numpy array."""
    if torch.is_tensor(values[0]):
        return torch.stack(values)
    return np.asarray(values)


def make_eval(loss_fn):
    def eval_fn(params, tokens):
        with torch.no_grad():
            loss, _ = loss_fn(params, {"tokens": tokens})
        return loss
    return eval_fn


def make_single_worker_step(loss_fn, tcfg: TrainConfig,
                            total_steps: int | None = None):
    """Plain (non-DiLoCo) training step, in place — the paper's
    pretraining stage and single-worker baselines. Under ``tcfg``'s
    precision policy: build the optimizer state with
    ``adamw.init(params, policy=precision.policy_of(tcfg))`` and pass the
    working params at its ``param_dtype``."""
    return make_inner_step(loss_fn, tcfg, total_steps)


def outer_wire_bytes(params, dcfg: DiLoCoConfig) -> float:
    """Bytes ONE replica ships for the classic synchronous outer step: the
    full float32 outer gradient (the classic round runs only at float32
    transport; streaming charges its fragments through
    ``streaming.sync_plan``)."""
    return float(sum(leaf.numel() for leaf in tree.leaves(params)) * 4.0)
