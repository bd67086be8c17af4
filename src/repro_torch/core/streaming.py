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
only the band. An apply before its fragment's first send is a no-op and
launches nothing.

Only ``transport="simulated"`` is ported; "sharded" and its packed wire
raise (ROADMAP.md, port queue: transports). ``pack_wire`` has no effect
on the simulated transport, as in the JAX package.
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import tree
from ..configs.base import DiLoCoConfig, TrainConfig
from ..kernels import ops as kops
from ..kernels.ref import f32
from ..optim import precision
from . import diloco, fragments
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
    leaf the fragment does not touch; ``mask`` is the (k,) communication
    mask snapshot taken at the send, used by the apply (also when it
    wraps into the next round). None when the config does not defer.
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
        payload = [None] * len(leaves)
        for reg in regs:
            leaf = leaves[reg.leaf]
            payload[reg.leaf] = torch.zeros(
                (k,) + _band_shape(leaf, reg), dtype=torch.float32,
                device=leaf.device)
        slots.append((tuple(payload), np.zeros((k,), np.float32)))
    return tuple(slots)


def init_state(params, dcfg: DiLoCoConfig) -> StreamState:
    """Start streaming DiLoCo from float32 ``params`` (cf.
    ``diloco.init_state``)."""
    P = max(1, int(dcfg.streaming_fragments))
    residual = None
    if dcfg.error_feedback and dcfg.outer_grad_dtype != "float32":
        residual = tree.map(
            lambda p: torch.zeros((dcfg.k,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device),
            params)
    return StreamState(
        base=diloco.init_state(params, dcfg),
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
    acc = m[0] * payload[0]
    for i in range(1, payload.shape[0]):
        acc = acc + m[i] * payload[i]
    return acc / denom


def make_stream_round_body(loss_fn, sample_fn, dcfg: DiLoCoConfig,
                           tcfg: TrainConfig, *, total_steps=None,
                           compute_cosine: bool = False, batch_size=None,
                           seq_len=None):
    """The streaming round, with ``diloco.make_round``'s signature:
    round(StreamState, gen, drop_mask, active_mask, weights) ->
    (StreamState, metrics). The state is updated in place and returned.

    The round draws its tokens as the classic round does (one
    ``sample_fn(gen, H·B, S)`` call), then runs the schedule's inner
    segments and fires its send and apply events in between. Metrics as
    the JAX streaming round's (the stream byte counts are host floats),
    plus the host seconds spent sampling (``sample_s``), in the inner
    segments (``inner_s``) and in the events (``outer_s``), each closed
    by a device synchronize."""
    P = int(dcfg.streaming_fragments)
    if P < 1:
        raise ValueError("make_stream_round_body needs "
                         "streaming_fragments >= 1")
    if dcfg.outer_opt != "nesterov":
        raise NotImplementedError(
            "streaming outer sync supports outer_opt='nesterov' only "
            f"(got {dcfg.outer_opt!r})")
    if dcfg.transport != "simulated":
        raise NotImplementedError(
            f"transport={dcfg.transport!r} is not ported yet (ROADMAP.md, "
            "port queue: transports)")
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
        m_np = drop * act * w
        m = torch.from_numpy(m_np).to(dev)
        denom = torch.clamp(m.sum(), min=1e-9)
        comm = [i for i in range(k) if m_np[i] > 0]
        adopt = [i for i in range(k)
                 if max(drop[i], np.float32(1.0) - act[i]) > 0]
        part, regions = _partition(gp, dcfg)
        wire = _fragment_wire_bytes(part, qdtype)
        gl, bl, pl, rl = (tree.leaves(t) for t in (gp, buf, pending, rp))
        # the deltas' and the merge's high-precision copy
        src = tree.leaves(ist.master if mixed else rp)
        resl = tree.leaves(residual) if residual is not None else None
        deltas = (tree.map(lambda r: torch.zeros(
            r.shape, dtype=torch.float32, device=dev), rp)
            if compute_cosine else None)
        count = st.outer_state.count

        t0 = time.perf_counter()
        toks = sample_fn(gen, H * B, S)[:k].reshape(k, H, B, S)
        diloco._sync(dev)
        sample_s = time.perf_counter() - t0
        inner_s = outer_s = 0.0
        pos, seg_loss = 0, []

        def send(frag):
            payload = [None] * len(gl) if defer else None
            for reg in regions[frag]:
                li = reg.leaf
                l0, l1, a, b, bs, be = _send_window(gl[li], reg, qdtype,
                                                    prune)
                off = 0
                if l0 is None:
                    d = gl[li][None] - src[li]
                else:
                    d = gl[li][l0:l1][None] - src[li][:, l0:l1]
                    off = l0 * (fragments._size(gl[li]) // gl[li].shape[0])
                if prune:
                    rows = kops.as_rows(d, 1)
                    if rows is not None:
                        kops.sign_prune(rows, dcfg.prune_frac, mode=mode)
                flat = d.reshape(k, -1)[:, a - off:b - off]
                if resl is not None:
                    res = resl[li].view(k, -1)
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
                    (k,) + _band_shape(gl[li], reg))
                if defer:
                    payload[li] = band.contiguous()
                else:
                    _band(pl[li], reg).copy_(_reduce(band, m, denom))
                if compute_cosine:
                    _band(tree.leaves(deltas)[li], reg, 1).copy_(band)
            if defer and regions[frag]:
                inflight[frag] = (tuple(payload), m_np.copy())
            armed[frag] = 1.0

        def apply(frag):
            nonlocal count
            if defer and inflight[frag] is not None:
                # the reduce of the collective sent τ steps ago, with the
                # mask snapshot of the round that sent it
                payload, m_snap = inflight[frag]
                ms_ = torch.from_numpy(m_snap).to(dev)
                den = torch.clamp(ms_.sum(), min=1e-9)
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
                    st.inner_steps_done + pos, active_mask=act)
                seg_loss.append(ms["loss"])
                pos += steps
            diloco._sync(dev)
            t2 = time.perf_counter()
            with torch.no_grad():
                for ev in events:
                    (send if ev.kind == "send" else apply)(ev.fragment)
            diloco._sync(dev)
            inner_s += t2 - t1
            outer_s += time.perf_counter() - t2

        loss = torch.cat(seg_loss, dim=1)
        base = st._replace(
            outer_state=OuterState(buf, st.outer_state.buf2, count),
            replica_params=rp, inner_state=ist, outer_t=st.outer_t + 1,
            inner_steps_done=st.inner_steps_done + H)
        om = {"outer_gnorm": diloco._tree_norm(pending),
              "drop_frac": float(np.float32(1.0) - drop.mean()),
              "inner_loss": loss.mean(),
              "inner_loss_last": loss[:, -1].mean(),
              # wire bytes one replica sends: at the largest sync event
              # and over the round's P syncs
              "stream_peak_sync_bytes": float(max(wire)),
              "stream_round_sync_bytes": float(sum(wire)),
              "sample_s": sample_s, "inner_s": inner_s, "outer_s": outer_s}
        if compute_cosine:
            om["cos_mean"], om["cos_std"] = diloco._pairwise_cosine(deltas,
                                                                    m)
        new_inflight = tuple(inflight) if defer else sstate.inflight
        return StreamState(base, pending, armed, residual,
                           new_inflight), om

    return round_body


def _fragment_wire_bytes(part: fragments.Partition, dtype: str) -> list:
    """Per fragment, the wire bytes of one sync of one replica, int4's
    scales charged per contiguous region (the unit a sender quantizes)."""
    return [float(sum(kops.transport_bytes(int(e), dtype) for e in regs))
            for regs in part.region_sizes]


def sync_plan(params, dcfg: DiLoCoConfig) -> tuple:
    """Per-fragment outer-sync plan of one streaming round, as the JAX
    ``streaming.sync_plan`` on the simulated transport: send and apply
    offsets, element count, region count and the per-replica wire bytes
    of one sync, the charge the round's stream metrics use."""
    P = max(1, int(dcfg.streaming_fragments))
    part, _ = _partition(params, dcfg)
    sched = fragments.schedule(P, dcfg.H, dcfg.stream_tau)
    wire = _fragment_wire_bytes(part, dcfg.outer_grad_dtype)
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
            "packed": False,
            "wire_bytes": wire[p],
            "crosses_round": int(sched.apply_offsets[p]) > int(dcfg.H),
            "deferred": deferred_consume(dcfg),
        })
    return tuple(plan)
