"""Streaming outer sync (Streaming DiLoCo, Douillard et al., 2025) on the
simulated transport, as the JAX ``core/streaming.py``.

Classic DiLoCo syncs the whole model every H steps. Streaming DiLoCo
syncs a stream of fragments instead:

  * the parameter tree is split into P contiguous fragments
    (``core/fragments.py``) sharing one outer Nesterov state;
  * fragment p's outer gradient is snapshotted ("sent") at inner offset
    p·H/P of the round, so at any instant ~1/P of the model is on the
    wire;
  * the reduced result is applied τ inner steps later, possibly in the
    next round: an all-reduce that runs while the replicas train on;
  * the synced fragment is merged with each replica's own progress,
    θ_i ← α·θ_global + (1−α)·θ_i (α=1 is the classic hard reset);
  * outer gradients take a per-replica quantize→dequantize round trip
    at the transport precision (``outer_grad_dtype``: float32, bfloat16
    or int4 with one f32 scale per 128 entries) before the simulated
    all-reduce, with optional error feedback (each replica keeps the
    rounding error and adds it to its next delta).

int4 scale blocks are formed over each replica's flattened leaf, as in
the JAX package: a block never mixes two replicas' values, but it may
span a fragment's band boundary within one replica (the JAX module calls
this a known approximation of a per-region sender). P=1, α=1, τ=0 with
float32 transport is bit-identical to ``diloco.make_round``'s classic
round (tested).

Where the JAX round computes a send, an apply and a merge over whole
leaves and then selects the fragment's entries with ``where``, the port
computes only on the fragment's layer band of each leaf, in place on the
state, which is exact elementwise: the outer Nesterov kernel updates the
band's contiguous slice, the merge and the residual write only the band.
An int4 send quantizes the band widened to whole 128-entry blocks of the
replica's flattened leaf, so the band gets the values a whole-leaf
quantization gives it. The in-flight payload of a deferred send keeps
only the band. An apply before its fragment's first send updates nothing
and launches no optimizer kernel (the packed sharded transport still
decodes the zero in-flight wire into ``pending``, as the JAX round does).

``transport="sharded"`` runs the same round on a process group of
``pods`` ranks (``core/pod_collectives.py``, ``launch/mesh.py``): rank r
holds the replica band [r·k/pods, (r+1)·k/pods), samples the full shard
set and keeps its band (so it trains on the simulated round's tokens),
and reduces each fragment by a real collective at its send: one
all-reduce of the float32 partial sums, or one all-gather of the
quantized payloads. With ``pack_wire`` (the default, bf16 and int4) a
send encodes each region of its band into the real wire format
(``ops.wire_encode``: int4 scale blocks start at the region, as in the
JAX package's packed sender), coalesces the regions into one buffer and
gathers it once; the consumer decodes and mask-reduces each region with
``ops.wire_reduce``, one launch of ``unpack_dequantize_reduce`` per int4
region. A deferred send (quantized, τ > 0) issues its gather with
``async_op=True`` and parks the handle; the apply τ inner steps later
waits for it. ``pack_wire`` has no effect on the simulated transport, as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import tree
from ..configs.base import DiLoCoConfig, TrainConfig
from ..kernels import ops as kops
from ..kernels import ref
from ..kernels.ref import f32
from ..optim import precision
from . import diloco, fragments, pod_collectives
from .outer_opt import OuterState


class StreamState(NamedTuple):
    """Streaming carry: the classic DiLoCo state plus the stream's
    bookkeeping.

    pending: param-shaped float32 tree; per fragment band, the most recent
    reduced (averaged, transport-quantized) outer gradient, written at
    the send (or, deferred, at the apply) and consumed by the apply.
    armed: (P,) float32 host array, 1 after a fragment's first send;
    applies before it are no-ops.
    residual: (k, ...) float32 error-feedback tree, or None (error
    feedback off, or float32 transport).
    inflight: per fragment, None or (payload, mask) for a deferred send
    (quantized transport with τ > 0): ``payload`` holds per leaf the
    (k, band...) transported values of the fragment's band, or None for a
    leaf the fragment does not touch; on the packed sharded transport it
    is the gathered (k, W) uint8 wire of all its regions instead. On the
    sharded transport a payload may still be in flight: a
    ``pod_collectives.Gathered`` handle (``pod_collectives.resolve``
    waits for it). ``mask`` is the (k,) communication mask snapshot taken
    at the send, used by the apply (also when it wraps into the next
    round). None when the config does not defer.

    On the sharded transport the per-replica leaves (replica params,
    AdamW state, residual) hold this rank's band of k / pods replicas;
    the rest is the same on every rank.
    """
    base: diloco.DiLoCoState
    pending: Any
    armed: np.ndarray
    residual: Any = None
    inflight: Any = None

    # read-through, so StreamState stands in for DiLoCoState's readers
    @property
    def global_params(self):
        return self.base.global_params

    @property
    def outer_state(self):
        return self.base.outer_state

    @property
    def replica_params(self):
        return self.base.replica_params

    @property
    def inner_state(self):
        return self.base.inner_state

    @property
    def outer_t(self):
        return self.base.outer_t

    @property
    def inner_steps_done(self):
        return self.base.inner_steps_done


def deferred_consume(dcfg: DiLoCoConfig) -> bool:
    """True when a send parks its transported payload and the apply τ
    steps later reduces it: the quantized transports at τ > 0. float32
    reduces at the send, and τ=0 has no window."""
    return (int(dcfg.streaming_fragments) >= 1
            and int(dcfg.stream_tau) > 0
            and dcfg.outer_grad_dtype in ("bfloat16", "int4"))


def _packed_wire(dcfg: DiLoCoConfig) -> bool:
    """The sharded quantized transport ships the real packed wire."""
    return (dcfg.transport == "sharded" and dcfg.pack_wire
            and dcfg.outer_grad_dtype in ("bfloat16", "int4"))


def _partition(params, dcfg):
    P = max(1, int(dcfg.streaming_fragments))
    part = fragments.partition_params(params, P,
                                      overrides=dcfg.stream_overrides)
    return part, fragments.fragment_regions(part, params)


def _band_shape(leaf, reg: fragments.Region) -> tuple:
    if reg.start is None:
        return tuple(leaf.shape)
    return (reg.stop - reg.start,) + tuple(leaf.shape[1:])


def _band(t, reg: fragments.Region, lead: int = 0):
    """The region's slice of ``t`` (a view; contiguous for a contiguous
    ``t`` with no leading dims, or a whole-leaf region)."""
    if reg.start is None:
        return t
    return t[(slice(None),) * lead + (slice(reg.start, reg.stop),)]


def _init_inflight(params, dcfg: DiLoCoConfig):
    """Zero in-flight slots: per fragment, a (k, band...) float32 payload
    for each leaf it touches and a (k,) zero mask; None for a fragment
    with no leaf (emptied by overrides). None when the config does not
    defer."""
    if not deferred_consume(dcfg):
        return None
    regions = _partition(params, dcfg)[1]
    leaves = tree.leaves(params)
    k = int(dcfg.k)
    slots = []
    for regs in regions:
        if not regs:
            slots.append(None)
            continue
        if _packed_wire(dcfg):
            W = sum(pod_collectives.wire_nbytes(r.elems,
                                                dcfg.outer_grad_dtype)
                    for r in regs)
            slots.append((torch.zeros((k, W), dtype=torch.uint8,
                                      device=leaves[0].device),
                          np.zeros((k,), np.float32)))
            continue
        payload = [None] * len(leaves)
        for reg in regs:
            leaf = leaves[reg.leaf]
            payload[reg.leaf] = torch.zeros(
                (k,) + _band_shape(leaf, reg), dtype=torch.float32,
                device=leaf.device)
        slots.append((tuple(payload), np.zeros((k,), np.float32)))
    return tuple(slots)


def init_state(params, dcfg: DiLoCoConfig, *, group=None) -> StreamState:
    """Start streaming DiLoCo from float32 ``params`` (cf.
    ``diloco.init_state``). With a pod ``group`` (the sharded transport)
    the per-replica leaves hold only this rank's band of k / pods
    replicas, as ``pod_collectives.shard_stream_state`` of the full state
    would (every replica starts from ``params``)."""
    P = max(1, int(dcfg.streaming_fragments))
    k_rep = dcfg.k // pod_collectives.pods_of(group)
    residual = None
    if dcfg.error_feedback and dcfg.outer_grad_dtype != "float32":
        residual = tree.map(
            lambda p: torch.zeros((k_rep,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device),
            params)
    return StreamState(
        base=diloco.init_state(params, dataclasses.replace(dcfg, k=k_rep)),
        pending=tree.map(torch.zeros_like, params),
        armed=np.zeros((P,), np.float32),
        residual=residual,
        inflight=_init_inflight(params, dcfg))


def quantize_with_feedback(d, res, dtype: str, *, mode: str = "auto"):
    """One error-feedback transport step: quantize ``d + res`` (the fresh
    delta plus the residual the quantizer left last time; (k, ...), each
    replica quantized on its own) and return (quantized, new residual)."""
    d_in = d + res
    q = kops.quant_roundtrip(d_in, dtype, mode=mode, stacked=True)
    return q, d_in - q


def _send_window(leaf, reg: fragments.Region, qdtype: str, prune: bool):
    """What a send computes for one leaf: (l0, l1, a, b, bs, be), the
    layers [l0, l1) whose deltas it takes, the per-replica flat range
    [a, b) it quantizes and the band [bs, be) it keeps. int4 widens the
    band to whole 128-entry blocks of the replica's flattened leaf;
    pruning takes whole rows (a stacked leaf's layers; a stacked vector is
    one row)."""
    n = fragments._size(leaf)
    if reg.start is None:
        return None, None, 0, n, 0, n
    L = int(leaf.shape[0])
    per = n // L
    bs, be = reg.start * per, reg.stop * per
    a, b = bs, be
    if qdtype == "int4":
        blk = kops.QUANT_BLOCK
        a, b = bs - bs % blk, min(n, be + (-be) % blk)
    l0, l1 = a // per, -(-b // per)
    if prune and len(leaf.shape) == 1:
        l0, l1 = 0, L
    return l0, l1, a, b, bs, be


def _reduce(payload, m, denom):
    """The weighted mean over replicas, in the classic round's order."""
    return ref.weighted_sum(payload, m) / denom


def make_stream_round_body(loss_fn, sample_fn, dcfg: DiLoCoConfig,
                           tcfg: TrainConfig, *, total_steps=None,
                           compute_cosine: bool = False, batch_size=None,
                           seq_len=None, group=None):
    """The streaming round, with ``diloco.make_round``'s signature:
    round(StreamState, gen, drop_mask, active_mask, weights) ->
    (StreamState, metrics). The state is updated in place and returned.

    The round draws its tokens as the classic round does (one
    ``sample_fn(gen, H·B, S)`` call), then runs the schedule's inner
    segments and fires its send and apply events in between. Metrics as
    the JAX streaming round's (the stream byte counts are host floats),
    plus the host seconds spent sampling (``sample_s``), in the inner
    segments (``inner_s``) and in the events (``outer_s``, of which
    ``wait_s`` waiting for deferred gathers at their applies), each closed
    by a device synchronize.

    ``dcfg.transport == "sharded"`` needs this rank's pod ``group``
    (``launch/mesh.py``): the state holds the rank's replica band, the
    loss metrics are the mean over all replicas (``replica_mean``)."""
    P = int(dcfg.streaming_fragments)
    if P < 1:
        raise ValueError("make_stream_round_body needs "
                         "streaming_fragments >= 1")
    if dcfg.outer_opt != "nesterov":
        raise NotImplementedError(
            "streaming outer sync supports outer_opt='nesterov' only "
            f"(got {dcfg.outer_opt!r})")
    if dcfg.transport not in ("simulated", "sharded"):
        raise ValueError(f"unknown transport {dcfg.transport!r}: expected "
                         "'simulated' or 'sharded'")
    sharded = dcfg.transport == "sharded"
    if sharded:
        pods = pod_collectives.validate_group(group, dcfg.k)
        if compute_cosine:
            raise NotImplementedError(
                "compute_cosine needs cross-pod delta gathers; run it on "
                "transport='simulated'")
        rank = group.rank
    else:
        pods, rank = 1, 0
    packed = _packed_wire(dcfg)
    defer = deferred_consume(dcfg)
    sched = fragments.schedule(P, dcfg.H, dcfg.stream_tau)
    alpha = float(dcfg.stream_alpha)
    qdtype = dcfg.outer_grad_dtype
    if qdtype not in kops.TRANSPORT_BYTES_PER_ELEM:
        raise ValueError(f"unknown outer_grad_dtype {qdtype!r}")
    mode = dcfg.kernel_mode
    prune = dcfg.prune_frac > 0
    mixed = precision.policy_of(dcfg).mixed
    lr, mu = f32(dcfg.outer_lr), f32(dcfg.outer_momentum)
    inner_step = diloco.make_inner_step(loss_fn, tcfg, total_steps)
    B = batch_size or tcfg.batch_size
    S = seq_len or tcfg.seq_len
    k_loc = dcfg.k // pods
    r0 = pod_collectives.local_band(k_loc, rank)
    probe = None if group is None else group.probe

    def round_body(sstate: StreamState, gen, drop_mask=None,
                   active_mask=None, weights=None):
        k, H = dcfg.k, dcfg.H
        ones = np.ones((k,), np.float32)
        drop = ones if drop_mask is None else np.asarray(drop_mask,
                                                         np.float32)
        act = ones if active_mask is None else np.asarray(active_mask,
                                                          np.float32)
        w = ones if weights is None else np.asarray(weights, np.float32)
        st = sstate.base
        gp, rp, ist = st.global_params, st.replica_params, st.inner_state
        buf = st.outer_state.buf
        pending, residual = sstate.pending, sstate.residual
        armed = np.array(sstate.armed, np.float32)
        if defer and sstate.inflight is None:
            raise ValueError(
                "a deferred streaming round (quantized, tau > 0) needs the "
                "in-flight slots: build the state with streaming.init_state "
                "under the same DiLoCoConfig")
        inflight = list(sstate.inflight) if defer else None
        dev = tree.leaves(gp)[0].device
        # the mask algebra is over all k replicas on every rank; only the
        # replica-banded tensors are local (indices below are local)
        m_np = drop * act * w
        m = torch.from_numpy(m_np).to(dev)
        denom = torch.clamp(m.sum(), min=1e-9)
        m_loc = m[r0:r0 + k_loc]
        comm = [i - r0 for i in range(r0, r0 + k_loc) if m_np[i] > 0]
        adopt = [i - r0 for i in range(r0, r0 + k_loc)
                 if max(drop[i], np.float32(1.0) - act[i]) > 0]
        part, regions = _partition(gp, dcfg)
        wire = _fragment_wire_bytes(part, qdtype, packed=packed)
        gl, bl, pl, rl = (tree.leaves(t) for t in (gp, buf, pending, rp))
        # the deltas' and the merge's high-precision copy
        src = tree.leaves(ist.master if mixed else rp)
        resl = tree.leaves(residual) if residual is not None else None
        deltas = (tree.map(lambda r: torch.zeros(
            r.shape, dtype=torch.float32, device=dev), rp)
            if compute_cosine else None)
        count = st.outer_state.count

        t0 = time.perf_counter()
        # every rank samples the full shard set and keeps its band, so the
        # sharded round trains on the simulated round's tokens
        toks = sample_fn(gen, H * B, S)[:k].reshape(k, H, B, S)[
            r0:r0 + k_loc]
        diloco._sync(dev)
        sample_s = time.perf_counter() - t0
        inner_s = outer_s = wait_s = 0.0
        pos, seg_loss = 0, []

        def delta(li, reg, window_dtype):
            """This rank's deltas of the layers a send of region ``reg``
            takes, pruned when asked: (the (k_loc, n) flat deltas, the
            send window, the flat offset of the window's first layer)."""
            win = _send_window(gl[li], reg, window_dtype, prune)
            l0, l1 = win[:2]
            if l0 is None:
                d = gl[li][None] - src[li]
            else:
                d = gl[li][l0:l1][None] - src[li][:, l0:l1]
            if prune:
                rows = kops.as_rows(d, 1)
                if rows is not None:
                    kops.sign_prune(rows, dcfg.prune_frac, mode=mode)
            off = 0 if l0 is None else \
                l0 * (fragments._size(gl[li]) // gl[li].shape[0])
            return d.reshape(k_loc, -1), win, off

        def send(frag):
            payload = [None] * len(gl) if defer else None
            bands = []
            for reg in regions[frag]:
                li = reg.leaf
                flat, (_, _, a, b, bs, be), off = delta(li, reg, qdtype)
                flat = flat[:, a - off:b - off]
                if resl is not None:
                    res = resl[li].view(k_loc, -1)
                    q, nres = quantize_with_feedback(
                        flat, res[:, a:b], qdtype, mode=mode)
                    # only replicas whose packet enters the mean consume
                    # their residual; dropped or inactive ones keep it
                    for i in comm:
                        res[i, bs:be] = nres[i, bs - a:be - a]
                else:
                    q = flat if qdtype == "float32" else flat.contiguous()
                    q = kops.quant_roundtrip(q, qdtype, mode=mode,
                                             stacked=True, out=q)
                band = q[:, bs - a:be - a].reshape(
                    (k_loc,) + _band_shape(gl[li], reg))
                if sharded:
                    bands.append(band)
                elif defer:
                    payload[li] = band.contiguous()
                else:
                    _band(pl[li], reg).copy_(_reduce(band, m, denom))
                if compute_cosine:
                    _band(tree.leaves(deltas)[li], reg, 1).copy_(band)
            if sharded and regions[frag]:
                if qdtype == "float32":
                    # THE cross-pod collective of f32: one all-reduce of
                    # the rank's partial sums
                    means = pod_collectives.fragment_mean(
                        bands, m_loc, denom, group=group)
                    for reg, a_ in zip(regions[frag], means):
                        _band(pl[reg.leaf], reg).copy_(a_)
                else:
                    got = pod_collectives.fragment_gather(
                        bands, dtype=qdtype, group=group, async_op=defer)
                    per_leaf = _per_leaf(regions[frag], len(gl))
                    if defer:
                        inflight[frag] = (got.then(per_leaf), m_np.copy())
                    else:
                        full = per_leaf(got.wait())
                        for reg in regions[frag]:
                            _band(pl[reg.leaf], reg).copy_(
                                _reduce(full[reg.leaf], m, denom))
            elif defer and regions[frag]:
                inflight[frag] = (tuple(payload), m_np.copy())
            armed[frag] = 1.0

        def packed_send(frag):
            """Encode each region of the band's deltas (+ residual) into
            the real wire format, coalesce, and issue ONE gather."""
            if not regions[frag]:         # override-emptied: no wire
                armed[frag] = 1.0
                return
            sent = []
            for reg in regions[frag]:
                flat, (_, _, _, _, bs, be), off = delta(reg.leaf, reg,
                                                        "float32")
                d_r = flat[:, bs - off:be - off]
                if resl is not None:
                    d_r = d_r + resl[reg.leaf].view(k_loc, -1)[:, bs:be]
                sent.append((reg.leaf, bs, be, d_r))
            buf, local = pod_collectives.encode_wire(
                [x[3] for x in sent], qdtype, mode=mode,
                with_local=resl is not None)
            if resl is not None:
                # communicating replicas consume their residual; dropped
                # or inactive ones keep accumulating
                for (li, bs, be, d_r), loc in zip(sent, local):
                    res = resl[li].view(k_loc, -1)
                    for i in comm:
                        res[i, bs:be] = d_r[i] - loc[i]
            got = pod_collectives.gather_wire(buf, group=group,
                                              async_op=defer)
            if defer:
                # park the handle and the mask snapshot; the decode runs
                # at the apply, τ inner steps from here
                inflight[frag] = (got, m_np.copy())
            else:
                packed_reduce(frag, got.wait(), m, denom)
            armed[frag] = 1.0

        def packed_reduce(frag, gathered, m_r, denom_r):
            """Decode and mask-reduce each region of one fragment's
            gathered (k, W) wire into ``pending``, with the mask of the
            round that sent it."""
            regs = regions[frag]
            for reg, a_ in zip(regs, pod_collectives.reduce_wire(
                    gathered, [r.elems for r in regs], qdtype, m_r,
                    denom_r, mode=mode)):
                fragments.region_put(pl[reg.leaf], reg, a_)

        def apply(frag):
            nonlocal count, wait_s
            if defer and inflight[frag] is not None:
                # the reduce of the collective sent τ steps ago, with the
                # mask snapshot of the round that sent it
                payload, m_snap = inflight[frag]
                ms_ = torch.from_numpy(m_snap).to(dev)
                den = torch.clamp(ms_.sum(), min=1e-9)
                t_w = time.perf_counter()
                payload = pod_collectives.resolve(payload)
                wait_s += time.perf_counter() - t_w
                if packed:
                    packed_reduce(frag, payload, ms_, den)
                else:
                    for reg in regions[frag]:
                        _band(pl[reg.leaf], reg).copy_(
                            _reduce(payload[reg.leaf], ms_, den))
            if armed[frag] <= 0:
                return                 # not sent yet: a no-op
            for reg in regions[frag]:
                li = reg.leaf
                g, bb, pe = (_band(t[li], reg) for t in (gl, bl, pl))
                if mode != "ref":
                    kops.nesterov_update_tree(g, pe, bb, lr=lr, momentum=mu,
                                              mode=mode)
                else:
                    b2 = mu * bb + pe
                    g2 = g - lr * (mu * b2 + pe)
                    bb.copy_(b2)
                    g.copy_(g2)
                # merge against the high-precision copy; the working copy
                # adopts the result at its storage dtype
                for i in adopt:
                    h = _band(src[li][i], reg)
                    if alpha >= 1.0:
                        tgt = g
                    else:
                        # the JAX weak-typed scalar takes h's dtype
                        beta = float(torch.tensor(1.0 - alpha,
                                                  dtype=h.dtype))
                        tgt = f32(alpha) * g + beta * h
                    _band(rl[li][i], reg).copy_(tgt)
                    if mixed:
                        h.copy_(tgt)
            count += 1

        for steps, events in sched.phases:
            t1 = time.perf_counter()
            if steps:
                seg = toks[:, pos:pos + steps]
                rp, ist, ms = diloco.inner_phase(
                    inner_step, rp, ist, {"tokens": seg},
                    st.inner_steps_done + pos,
                    active_mask=act[r0:r0 + k_loc])
                seg_loss.append(ms["loss"])
                pos += steps
            diloco._sync(dev)
            t2 = time.perf_counter()
            if probe is not None:       # where the sync events happen
                probe.at(st.outer_t, st.inner_steps_done + pos)
            with torch.no_grad():
                for ev in events:
                    if ev.kind == "apply":
                        apply(ev.fragment)
                    elif packed:
                        packed_send(ev.fragment)
                    else:
                        send(ev.fragment)
            diloco._sync(dev)
            inner_s += t2 - t1
            outer_s += time.perf_counter() - t2

        loss = torch.cat(seg_loss, dim=1)
        base = st._replace(
            outer_state=OuterState(buf, st.outer_state.buf2, count),
            replica_params=rp, inner_state=ist, outer_t=st.outer_t + 1,
            inner_steps_done=st.inner_steps_done + H)
        if sharded:
            # the loss lives per local replica band: fold the bands into
            # the mean over all replicas (equal bands, the JAX pmean)
            loss_mean = pod_collectives.replica_mean(loss, group=group)
            loss_last = pod_collectives.replica_mean(loss[:, -1],
                                                     group=group)
        else:
            loss_mean, loss_last = loss.mean(), loss[:, -1].mean()
        om = {"outer_gnorm": diloco._tree_norm(pending),
              "drop_frac": float(np.float32(1.0) - drop.mean()),
              "inner_loss": loss_mean,
              "inner_loss_last": loss_last,
              # wire bytes one replica sends: at the largest sync event
              # and over the round's P syncs (the packed wire's exact
              # bytes on the packed sharded transport)
              "stream_peak_sync_bytes": float(max(wire)),
              "stream_round_sync_bytes": float(sum(wire)),
              "sample_s": sample_s, "inner_s": inner_s, "outer_s": outer_s,
              "wait_s": wait_s}
        if compute_cosine:
            om["cos_mean"], om["cos_std"] = diloco._pairwise_cosine(deltas,
                                                                    m)
        new_inflight = tuple(inflight) if defer else sstate.inflight
        return StreamState(base, pending, armed, residual,
                           new_inflight), om

    return round_body


def _per_leaf(regs, n_leaves: int):
    """Maps a gathered fragment's per-region payloads to the per-leaf
    tuple of the in-flight slot (None for a leaf it does not touch)."""
    def to_leaves(payloads):
        out = [None] * n_leaves
        for reg, pay in zip(regs, payloads):
            out[reg.leaf] = pay
        return tuple(out)
    return to_leaves


def _fragment_wire_bytes(part: fragments.Partition, dtype: str, *,
                         packed: bool = False) -> list:
    """Per fragment, the wire bytes of one sync of one replica, int4's
    scales charged per contiguous region (the unit a sender quantizes);
    ``packed``: the packed wire's exact bytes."""
    return [float(sum(kops.transport_bytes(int(e), dtype, packed=packed)
                      for e in regs))
            for regs in part.region_sizes]


def sync_plan(params, dcfg: DiLoCoConfig) -> tuple:
    """Per-fragment outer-sync plan of one streaming round, as the JAX
    ``streaming.sync_plan``: send and apply offsets, element count,
    region count and the per-replica wire bytes of one sync (byte-exact
    packed accounting on the packed sharded transport, the static model
    elsewhere), the charge the round's stream metrics use."""
    P = max(1, int(dcfg.streaming_fragments))
    part, _ = _partition(params, dcfg)
    sched = fragments.schedule(P, dcfg.H, dcfg.stream_tau)
    packed = _packed_wire(dcfg)
    wire = _fragment_wire_bytes(part, dcfg.outer_grad_dtype, packed=packed)
    plan = []
    for p in range(P):
        regs = part.region_sizes[p]
        plan.append({
            "fragment": p,
            "send_step": int(sched.send_offsets[p]),
            "apply_step": int(sched.apply_offsets[p]),
            "elems": int(part.sizes[p]),
            "regions": len(regs),
            "wire_dtype": dcfg.outer_grad_dtype,
            "packed": packed,
            "wire_bytes": wire[p],
            "crosses_round": int(sched.apply_offsets[p]) > int(dcfg.H),
            "deferred": deferred_consume(dcfg),
        })
    return tuple(plan)
