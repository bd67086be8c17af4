"""Streaming rounds of the sharded transport on given parameters, tokens
and masks, one call per pod rank (``launch/mesh.spawn`` runs ``rounds``
on every rank): what the parity checks of the sharded transport run (the
port against the JAX package and against its own simulated round, the
card against the CPU).

    results = mesh.spawn("repro_torch.launch.pod_rounds:rounds", layout,
                         model_cfg, dcfg, tcfg, tokens, masks, params,
                         state)

Each round r draws ``tokens[r]`` (k, H·B, S) as its shard batches, under
``masks[r]`` = (drop, active, weights). Rank 0 returns the full state
after the rounds (``pod_collectives.gather_stream_state``, written out
by ``convert.stream_state_to_numpy``); every rank returns its round
metrics, its collective traffic and kernel launches over the rounds, the
count of deferred gathers not yet waited for at the end (those whose
apply falls in the next round), and a digest of the state every rank
holds in full (global params, outer state, pending, armed, in-flight),
which must agree across the ranks. With ``snapshot`` (a path) rank 0
also writes the gathered state there as the trainer writes a snapshot
(``resilience.wrap``: the envelope's generator state is that of a CPU
generator seeded 0, its cursor the rounds run).

``reband`` is the elastic resume's placement alone: every rank loads a
snapshot at host placement, takes its band for this group's pod count
and the ranks gather it again, with no round between; rank 0 writes the
result where it is asked to, to be held against the snapshot bit for
bit.
"""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from .. import check, convert, resilience, tree
from ..checkpoint import checkpoint as ckpt
from ..core import diloco, pod_collectives, streaming
from ..kernels import ops as kops
from ..models.registry import Arch


def shared_digest(state) -> str:
    """sha256 of the bytes of every leaf the ranks share, in a fixed
    order (in-flight gathers waited for)."""
    h = hashlib.sha256()
    st = state.base
    parts = [*tree.leaves(st.global_params), *tree.leaves(st.outer_state.buf),
             *tree.leaves(state.pending),
             torch.from_numpy(np.asarray(state.armed, np.float32))]
    for slot in state.inflight or ():
        if slot is None:
            continue
        payload = pod_collectives.resolve(slot[0])
        parts += [payload] if torch.is_tensor(payload) else \
            [t for t in payload if t is not None]
        parts.append(torch.from_numpy(np.asarray(slot[1], np.float32)))
    for t in parts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def rounds(group, model_cfg, dcfg, tcfg, tokens, masks, params=None,
           state=None, snapshot=None, record_sends=False):
    """``len(masks)`` sharded rounds on this rank, from the full
    ``state`` (a port ``StreamState``, banded here) or, without one, from
    ``params`` (``streaming.init_state``). With ``record_sends`` the rank
    also returns its sends (``check.TransportSteps.record``), for the
    transport's flip rule. See the module's doc."""
    dev = group.device
    arch = Arch(cfg=model_cfg)
    if state is None:
        state = streaming.init_state(
            tree.map(lambda t: t.to(dev), params), dcfg, group=group)
    else:
        state = pod_collectives.shard_stream_state(state, group)
    B, S = tcfg.batch_size, tcfg.seq_len
    rnd = diloco.make_round(lambda p, b: arch.loss(p, b),
                            lambda r, b, s: tokens[r].to(dev), dcfg, tcfg,
                            batch_size=B, seq_len=S, group=group)
    metrics = []
    steps = check.TransportSteps(state.base.global_params, dcfg) \
        if record_sends else contextlib.nullcontext()
    with steps:
        for r, (drop, act, w) in enumerate(masks):
            state, m = rnd(state, r, drop, act, w)
            metrics.append({name: float(v) for name, v in m.items()})
    traffic = dict(group.traffic)
    launches = kops.launch_counts()
    # deferred gathers issued but not yet waited for: those whose apply
    # falls in the next round
    unwaited = sum(isinstance(slot[0], pod_collectives.Gathered)
                   and not slot[0].done
                   for slot in state.inflight or () if slot is not None)
    digest = shared_digest(state)
    full = pod_collectives.gather_stream_state(state, group)
    if snapshot is not None and full is not None:
        ckpt.save(snapshot, resilience.wrap(
            full, torch.Generator().manual_seed(0), len(masks)))
    return {"rank": group.rank, "metrics": metrics, "traffic": traffic,
            "launches": launches, "shared": digest, "unwaited": unwaited,
            "state": None if full is None
            else convert.stream_state_to_numpy(full, dcfg),
            "sends": steps.record() if record_sends else None}


def packed_means(group, params, d, m, cases):
    """The packed transport's pending tree (``pod_collectives.
    packed_mean_tree``) of the (k, ...) deltas ``d`` under the (k,)
    weights ``m``, this rank sending its band, for each (P, dtype) of
    ``cases``. Rank 0 returns {(P, dtype): numpy tree}, the others the
    same."""
    k_loc = tree.leaves(d)[0].shape[0] // group.pods
    band = tree.map(lambda x: pod_collectives.band_slice(
        x, k_loc, group.rank).to(group.device), d)
    return {(P, dt): convert.params_to_numpy(pod_collectives.packed_mean_tree(
        group, params, band, m, P, dt)) for P, dt in cases}


def reband(group, model_cfg, dcfg, path, out_path):
    """Load the snapshot at ``path`` (a full sharded streaming state of
    ``model_cfg``'s parameters under ``dcfg``) on the host, band it for
    this group as a resume does (``pod_collectives.shard_stream_state``),
    gather it again (``gather_stream_state``) and, on rank 0, write the
    envelope to ``out_path``. Returns this rank's band size."""
    meta = Arch(cfg=model_cfg).init(generator=None, device="meta")
    loaded = ckpt.restore_tree(path)
    # the generator state as written (a CUDA or a CPU generator's)
    example = resilience.wrap(streaming.init_state(meta, dcfg),
                              loaded["rng"]["key"].numpy(), 0)
    full, key, done = resilience.unwrap(ckpt.reshape_like(loaded, example))
    state = pod_collectives.shard_stream_state(full, group)
    back = pod_collectives.gather_stream_state(state, group)
    if back is not None:
        ckpt.save(out_path, resilience.wrap(back, key, done))
    return tree.leaves(state.base.replica_params)[0].shape[0]


def gossip_exchanges(group, est, stages, mix: float):
    """For each butterfly ``stage``, one exchange of the (k, ...) estimate
    tree ``est`` (the full tree on the host) on this rank's band
    (``gossip.pod_mix_round``). Returns [(this rank's band of the result,
    as numpy, the exchanges it made)] by stage."""
    from ..core import gossip
    k = tree.leaves(est)[0].shape[0]
    k_loc = k // group.pods
    band = tree.map(lambda x: pod_collectives.band_slice(
        x, k_loc, group.rank).to(group.device), est)
    out = []
    for stage in stages:
        before = group.traffic["exchange"]
        got = gossip.pod_mix_round(
            band, gossip.partner_map(k, stage, "butterfly"),
            tree.map(lambda _: 1.0, est), mix=mix, group=group)
        out.append((convert.params_to_numpy(got),
                    group.traffic["exchange"] - before))
    return out
