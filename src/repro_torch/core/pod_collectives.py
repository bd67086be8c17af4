"""Real pod-axis collectives for the streaming outer sync, on a
``torch.distributed`` process group (the JAX ``core/pod_collectives.py``).

The simulated transport (``core/streaming.py``) averages replica-stacked
tensors in one process. Here each DiLoCo island is a rank of a process
group of ``pods`` ranks (``launch/mesh.py``): rank r holds the contiguous
band of replicas [r·k_loc, (r+1)·k_loc), k_loc = k / pods, runs their
inner steps with no communication, and each fragment's outer gradient is
reduced by a real collective at its send:

  float32   ``fragment_mean``: each rank's partial
            ``Σ_{j in band} m_j·Δ_j`` (in replica order) is summed over the
            ranks by one ``all_reduce`` per fragment, then divided by the
            mask sum. With one replica per rank and 0/1 masks the products
            are exact and a two-rank sum is the simulated reduce's
            ``m_0·Δ_0 + m_1·Δ_1``: bit for bit the simulated round.
  bfloat16  ``fragment_gather``: the payload is on the bf16 grid, so the
            wire carries real bf16; upcast on arrival (exact), then the
            simulated reduce over all k replicas.
  int4      the fake-quant payload (``pack_wire=False``) is gathered as
            float32; with the packed wire (the default) each region's
            codes and scales are encoded on the sender (``ops.
            wire_encode``), all regions coalesced into one (k_loc, W)
            byte buffer, and ``gather_wire`` makes ONE all-gather per
            fragment per sync: exactly the bytes ``ops.transport_bytes(...,
            packed=True)`` charges.

Every quantized collective gathers and reduces locally: summing encoded
payloads is meaningless, and the local reduce in replica order gives
every rank the same bits. The shared state (global params, outer state,
pending, armed, in-flight) is therefore bit-identical on every rank by
construction; error-feedback residuals and AdamW moments are rank-local
and never touch the wire.

The collectives run on the group's backend: NCCL when every rank has a
card of its own, gloo when ranks share a card or run on the CPU
(``launch/mesh.py`` decides before the run). On gloo a CUDA tensor is
staged through pinned host memory: that one buffer crosses to the host,
the compute stays on the card. ``PodGroup.traffic`` counts, at the call
sites, the collectives and the bytes this rank hands to them.
"""
from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from .. import tree
from ..kernels import ops as kops
from ..kernels import ref
from . import fragments

POD_AXIS = "pod"


class PodGroup:
    """This rank's place on the pod axis: rank ``rank`` of ``pods`` in the
    process group ``group`` (None: the default group), computing on
    ``device``. ``staged``: collectives take host copies of CUDA tensors
    (gloo). ``traffic`` counts the collective calls by kind and the bytes
    this rank contributes: ``wire_bytes`` for the outer gradients'
    collectives, ``metric_bytes`` for the round metrics' means; the
    resilience layer's agreements (barriers, rank 0's decisions, digest
    checks) count as ``control`` calls and ``control_bytes``; a gossip
    ``exchange`` counts as an ``exchange`` call and wire bytes. ``probe``
    (an ``OverlapProbe``, None unless a trace asks for it) records when
    each of the rounds' collectives is issued and consumed.

    The wire collectives communicate in ``_all_reduce``, ``_all_gather``
    and ``_exchange``, so a group that only counts (``launch/
    comm_analysis.CountingGroup``) keeps this accounting by overriding
    them."""

    def __init__(self, rank: int, pods: int, *, device, backend: str,
                 staged: bool = False, group=None):
        self.rank, self.pods = int(rank), int(pods)
        self.device = torch.device(device)
        self.backend, self.staged, self.group = backend, bool(staged), group
        self.traffic = dict.fromkeys(
            ("all_reduce", "all_gather", "gather_wire", "exchange",
             "wire_bytes", "metric_bytes", "control", "control_bytes"), 0)
        self.probe: OverlapProbe | None = None

    def _host(self, x):
        if not (self.staged and x.device.type == "cuda"):
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return h.copy_(x)

    def all_reduce(self, x, *, metric: bool = False):
        """Sum ``x`` (contiguous) over the ranks, in place; returns it."""
        self.traffic["all_reduce"] += 1
        self.traffic["metric_bytes" if metric else "wire_bytes"] += \
            x.numel() * x.element_size()
        src = self._host(x)
        self._all_reduce(src)
        if src is not x:
            x.copy_(src)
        if self.probe is not None:        # consumed where it is issued
            self.probe.consume(self.probe.issue("all_reduce", False))
        return x

    def all_gather(self, x, *, async_op: bool = False, kind="all_gather",
                   bill: str = "wire_bytes"):
        """Gather the (k_loc, ...) band ``x`` of every rank into one (k,
        ...) tensor in replica order: a ``Gathered`` handle whose
        ``wait()`` returns it (already complete unless ``async_op``).
        Counted as one ``kind`` call and its bytes under ``bill``."""
        x = x.contiguous()
        self.traffic[kind] += 1
        self.traffic[bill] += x.numel() * x.element_size()
        src = self._host(x)
        out = torch.empty((self.pods * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=src.device,
                          pin_memory=src is not x)
        work = self._all_gather(out, src, async_op)
        on_wait = None
        if self.probe is not None and bill == "wire_bytes":
            on_wait = functools.partial(self.probe.consume,
                                        self.probe.issue(kind, async_op))
        return Gathered(work, out, x.device, on_wait=on_wait)

    def exchange(self, x, partner: int):
        """Send ``x`` to rank ``partner`` and receive that rank's tensor of
        the same shape and dtype (a paired isend / irecv: ``partner`` must
        name this rank in turn). Counted as one ``exchange`` call and its
        bytes as wire bytes. ``partner == rank`` sits out: ``x`` comes back
        and nothing is counted."""
        if int(partner) == self.rank:
            return x
        x = x.contiguous()
        self.traffic["exchange"] += 1
        self.traffic["wire_bytes"] += x.numel() * x.element_size()
        src = self._host(x)
        recv = torch.empty(x.shape, dtype=x.dtype, device=src.device,
                           pin_memory=src is not x)
        self._exchange(src, recv, int(partner))
        return recv.to(x.device)

    def barrier(self):
        """Wait until every rank has reached this call."""
        self.traffic["control"] += 1
        dist.barrier(group=self.group)

    def decide(self, value: int) -> int:
        """Rank 0's ``value`` (an int), on every rank: one broadcast."""
        self.traffic["control"] += 1
        self.traffic["control_bytes"] += 8
        x = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        src = self._host(x)
        dist.broadcast(src, src=0, group=self.group)
        return int(src[0])

    def agree(self, data: bytes) -> bool:
        """Whether ``data`` is the same on every rank: one all-gather of
        its sha256 digest."""
        digest = torch.frombuffer(bytearray(hashlib.sha256(data).digest()),
                                  dtype=torch.uint8).to(self.device)
        got = self.all_gather(digest[None], kind="control",
                              bill="control_bytes").wait()
        return bool((got == got[0]).all())

    # the communication: what a counting group overrides
    def _all_reduce(self, src):
        dist.all_reduce(src, group=self.group)

    def _all_gather(self, out, src, async_op: bool):
        return _GATHER(out, src, group=self.group, async_op=async_op)

    def _exchange(self, src, recv, partner: int):
        # one batch of the send and the receive: both ranks post both
        # together, which NCCL needs (two ranks that each send before
        # they receive can deadlock there); gloo takes the batch too
        ops = [dist.P2POp(dist.isend, src, partner, group=self.group),
               dist.P2POp(dist.irecv, recv, partner, group=self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()


# the single-tensor all-gather of this PyTorch: ``all_gather_single``
# where it exists (``all_gather_into_tensor`` is deprecated in its favour
# there), else ``all_gather_into_tensor``; both take gloo and NCCL
_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Gathered:
    """An issued all-gather: ``wait()`` blocks until its result is there
    (moved back to the card when the group stages through the host) and
    returns it; later calls return the same tensor. ``on_wait`` is called
    at the first ``wait()``."""

    def __init__(self, work, out, device, finish=None, on_wait=None):
        self._work, self._out, self._device = work, out, device
        self._finish, self._on_wait = finish, on_wait
        self._done = None

    def then(self, finish):
        """The same gather, its result passed through ``finish`` (after
        this one's own) on wait."""
        first = self._finish
        return Gathered(self._work, self._out, self._device,
                        finish if first is None
                        else lambda out: finish(first(out)), self._on_wait)

    @property
    def done(self) -> bool:
        """Whether ``wait`` has been called."""
        return self._done is not None

    def wait(self):
        if self._done is None:
            if self._on_wait is not None:       # an overlap probe's mark
                self._on_wait()
            if self._work is not None:
                self._work.wait()
            out = self._out.to(self._device)
            self._done = out if self._finish is None else self._finish(out)
            self._work = self._out = None
        return self._done


class OverlapProbe:
    """Issue→consume offsets of a pod rank's collectives, measured on the
    run itself: the counterpart of the JAX ``hlo_analysis.stream_overlap``,
    which reads them from the lowered round's HLO text (the port has no
    HLO). The streaming round tells the probe where it is (``at``: the
    round and the inner-step counter, before each batch of sync events);
    ``PodGroup`` reports each round collective's issue and the first
    ``wait()`` on it (an all-reduce is consumed where it is issued). Each
    row holds the inner steps and the model's forward matmuls
    (``models.layers.matmuls``, a host counter) at both ends. Nothing here
    reads the card."""

    def __init__(self):
        self.round = self.step = 0
        self.rows: list = []
        self._seq = 0

    def at(self, round_: int, step: int):
        self.round, self.step = int(round_), int(step)

    def _mark(self) -> tuple:
        from ..models import layers
        self._seq += 1
        return self._seq, self.round, self.step, layers.matmuls

    def issue(self, op: str, deferred: bool) -> dict:
        seq, rnd, step, dots = self._mark()
        row = {"collective": f"{op}.{seq}", "op": op, "issue_id": seq,
               "deferred": bool(deferred), "round": rnd, "_at": (step, dots)}
        self.rows.append(row)
        return row

    def consume(self, row: dict):
        if "consume_id" in row:
            return
        seq, rnd, step, dots = self._mark()
        row.update(consume_id=seq, wrapped=rnd > row["round"],
                   steps_between=step - row["_at"][0],
                   dots_between=dots - row["_at"][1])

    def overlap(self, tau: int | None = None) -> dict:
        """The rows of one round in ``stream_overlap``'s layout: issue
        order, ``consume_id``, ``wrapped`` (consumed in a later round),
        ``deferred`` (issued asynchronously), ``steps_between`` and
        ``dots_between``, with ``n_collectives``, ``n_deferred``,
        ``min_steps_between``, ``min_dots_between`` and, given ``tau``,
        ``ok`` (every deferred row at least tau steps). The round is the
        first whose every collective was consumed (else the first)."""
        rounds = sorted({r["round"] for r in self.rows})
        pick = next((rd for rd in rounds
                     if all("consume_id" in r for r in self.rows
                            if r["round"] == rd)),
                    rounds[0] if rounds else None)
        rows = [{kk: v for kk, v in r.items() if kk != "_at"}
                for r in self.rows if r["round"] == pick]
        for r in rows:
            r.setdefault("consume_id", None)
            r.setdefault("wrapped", True)
            r.setdefault("steps_between", None)
            r.setdefault("dots_between", None)
        wire = [r for r in rows if r["deferred"]]
        out = {"source": "measured", "round": pick, "rows": rows,
               "n_collectives": len(rows), "n_deferred": len(wire),
               "min_steps_between": min(
                   (r["steps_between"] for r in wire
                    if r["steps_between"] is not None), default=0),
               "min_dots_between": min(
                   (r["dots_between"] for r in wire
                    if r["dots_between"] is not None), default=0)}
        if tau is not None:
            out["tau"] = int(tau)
            out["ok"] = bool(wire) and all(
                r["steps_between"] is not None
                and r["steps_between"] >= tau for r in wire)
        return out


def resolve(payload):
    """An in-flight payload, its gather waited for."""
    return payload.wait() if isinstance(payload, Gathered) else payload


def pods_of(group: PodGroup | None) -> int:
    """Ranks on the pod axis (1 without a group)."""
    return 1 if group is None else group.pods


def check_bands(k: int, pods: int) -> None:
    """Raise unless ``pods`` divide ``k``: replicas lie in contiguous
    bands of k / pods, one per pod."""
    if k % pods != 0:
        raise ValueError(
            f"k={k} replicas cannot be banded over {pods} pods: pods must "
            "divide k (one contiguous replica band per pod)")


def validate_group(group: PodGroup | None, k: int) -> int:
    """Check ``group`` can host ``k`` replicas in contiguous bands of k /
    pods; returns the pod count."""
    if group is None:
        raise ValueError(
            "transport='sharded' needs a pod group: pass group=... to "
            "make_round (see launch/mesh.py)")
    check_bands(k, group.pods)
    return group.pods


def local_band(k_local: int, rank: int) -> int:
    """Start index of rank ``rank``'s replica band."""
    return rank * k_local


def band_slice(x, k_local: int, rank: int):
    """Rank ``rank``'s (k_local, ...) band of a replicated (k, ...)
    array (a view)."""
    s = local_band(k_local, rank)
    return x[s:s + k_local]


def fragment_mean(d_local, m_local, denom, *, group: PodGroup):
    """The float32 masked mean of one fragment over all replicas:
    ``d_local`` is a list of this rank's (k_loc, ...) region payloads,
    ``m_local`` its band of the mask. The rank's partial sums (replica
    order, ``ref.weighted_sum``) cross in ONE all-reduce; returns the
    regions' means, each divided by ``denom``."""
    parts = [ref.weighted_sum(d, m_local).reshape(-1) for d in d_local]
    flat = group.all_reduce(torch.cat(parts))
    out, off = [], 0
    for d in d_local:
        n = d[0].numel()
        out.append(flat[off:off + n].view(d.shape[1:]) / denom)
        off += n
    return out


def fragment_gather(d_local, *, dtype: str, group: PodGroup,
                    async_op: bool = False) -> Gathered:
    """The collective half of a quantized fragment: gather this rank's
    (k_loc, ...) region payloads (transport-quantized values) over the
    pods WITHOUT reducing, coalesced into one all-gather. bfloat16
    payloads cross as real bf16 (exact: they lie on its grid) and are
    upcast on arrival. ``wait()`` returns the (k, ...) payloads in replica
    order, one per region."""
    k_loc = d_local[0].shape[0]
    wire_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    flat = torch.cat([d.reshape(k_loc, -1).to(wire_dt) for d in d_local],
                     dim=1)
    shapes = [tuple(d.shape[1:]) for d in d_local]

    def split(g):
        out, off = [], 0
        for s in shapes:
            n = int(np.prod(s, dtype=np.int64))
            out.append(g[:, off:off + n].float().reshape((g.shape[0],) + s))
            off += n
        return out

    return group.all_gather(flat, async_op=async_op).then(split)


def gather_wire(wire_local, *, group: PodGroup,
                async_op: bool = False) -> Gathered:
    """THE packed-wire collective: all-gather one fragment's coalesced
    per-replica wire bytes (k_loc, W) uint8 over the pods; ``wait()``
    returns (k, W) in replica order. One call per fragment per sync is
    the quantized sharded transport's whole cross-pod bill."""
    return group.all_gather(wire_local, async_op=async_op,
                            kind="gather_wire")


def wire_nbytes(n: int, dtype: str) -> int:
    """Bytes of one region's packed wire of ``n`` entries."""
    return kops.wire_elems(n, dtype) * (2 if dtype == "bfloat16" else 1)


def encode_wire(d_regions, dtype: str, *, mode: str = "auto",
                with_local: bool = False):
    """The packed sender: each (k_loc, n) float32 region payload of the
    band, replica by replica, into the real wire format (``ops.
    wire_encode``; int4 scale blocks start at the region), and every
    region's wire concatenated per replica into ONE (k_loc, W) uint8
    buffer. Returns (buffer, the senders' values per region (k_loc, n) or
    None)."""
    wires, local = [], []
    for d in d_regions:
        enc = [kops.wire_encode(d[i], dtype, mode=mode,
                                with_local=with_local)
               for i in range(d.shape[0])]
        wires.append(torch.stack([e[0].view(torch.uint8) for e in enc]))
        if with_local:
            local.append(torch.stack([e[1] for e in enc]))
    return torch.cat(wires, dim=1), (local if with_local else None)


def reduce_wire(gathered, elems, dtype: str, m, denom, *,
                mode: str = "auto") -> list:
    """The packed consumer: the gathered (k, W) wire of one fragment,
    region by region (``elems``: their entry counts, in wire order),
    decoded and mask-reduced to the transported mean (``ops.wire_reduce``:
    int4 under a kernel mode is one ``unpack_dequantize_reduce`` launch a
    region). Returns the regions' (n,) float32 means."""
    out, off = [], 0
    for n in elems:
        nb = wire_nbytes(n, dtype)
        g = gathered[:, off:off + nb]
        if dtype == "bfloat16":
            g = g.view(torch.uint16)
        off += nb
        out.append(kops.wire_reduce(g, n, dtype, m, denom, mode=mode))
    return out


def packed_mean_tree(group: PodGroup, params, d_local, m, P: int,
                     dtype: str, *, mode: str = "auto"):
    """The pending tree of the packed transport for this rank's (k_loc,
    ...) deltas ``d_local`` (every replica communicating with the (k,)
    weights ``m``): per fragment of ``params``' P-way partition, encode
    every region of the band, ONE ``gather_wire``, decode and masked
    mean: the streaming round's packed send at the wire level (as the
    JAX tests' ``_packed_mean_tree``)."""
    part = fragments.partition_params(params, P)
    regions = fragments.fragment_regions(part, params)
    dev = group.device
    m = torch.as_tensor(np.asarray(m, np.float32)).to(dev)
    denom = torch.clamp(m.sum(), min=1e-9)
    pend = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=dev), params)
    pl, dl = tree.leaves(pend), tree.leaves(d_local)
    for regs in regions:
        if not regs:
            continue
        buf, _ = encode_wire([fragments.region_take(dl[r.leaf], r, 1)
                              for r in regs], dtype, mode=mode)
        g = gather_wire(buf, group=group).wait()
        for r, a in zip(regs, reduce_wire(g, [r.elems for r in regs],
                                          dtype, m, denom, mode=mode)):
            fragments.region_put(pl[r.leaf], r, a)
    return pend


def replica_mean(x_local, *, group: PodGroup):
    """Global mean of a metric carried per local replica band (equal
    bands: the mean of the ranks' means)."""
    v = x_local.float().mean().reshape(1)
    return group.all_reduce(v, metric=True)[0] / group.pods


# ---------------------------------------------------------------------------
# state placement
# ---------------------------------------------------------------------------

def _band_tree(t, k_loc, rank):
    return tree.map(lambda x: band_slice(x, k_loc, rank).clone(), t)


def shard_stream_state(state, group: PodGroup):
    """This rank's part of a full ``streaming.StreamState``: its band of
    the per-replica leaves (replica params, AdamW m, v, count and master,
    the error-feedback residual), a copy of the shared ones (global
    params, outer state, pending, armed, in-flight). Every returned leaf
    is a fresh tensor, moved to the group's device."""
    from .streaming import StreamState
    k = tree.leaves(state.base.replica_params)[0].shape[0]
    validate_group(group, k)
    k_loc, r = k // group.pods, group.rank
    st = state.base
    ist = st.inner_state
    dev = group.device
    move = lambda t: tree.map(lambda x: x.to(dev, copy=True), t)
    base = st._replace(
        global_params=move(st.global_params),
        outer_state=st.outer_state._replace(
            buf=move(st.outer_state.buf), buf2=move(st.outer_state.buf2)),
        replica_params=move(_band_tree(st.replica_params, k_loc, r)),
        inner_state=ist._replace(
            m=move(_band_tree(ist.m, k_loc, r)),
            v=move(_band_tree(ist.v, k_loc, r)),
            count=np.array(band_slice(np.asarray(ist.count), k_loc, r)),
            master=None if ist.master is None
            else move(_band_tree(ist.master, k_loc, r))))
    inflight = None
    if state.inflight is not None:
        inflight = tuple(
            None if slot is None else
            (_move_payload(resolve(slot[0]), dev),
             np.array(slot[1], np.float32))
            for slot in state.inflight)
    return StreamState(
        base=base, pending=move(state.pending),
        armed=np.array(state.armed, np.float32),
        residual=None if state.residual is None
        else move(_band_tree(state.residual, k_loc, r)),
        inflight=inflight)


def _move_payload(payload, dev):
    """A copy on ``dev`` of an in-flight payload: the packed wire, or the
    per-leaf tuple (None for a leaf the fragment does not touch)."""
    if torch.is_tensor(payload):
        return payload.to(dev, copy=True)
    return tuple(None if t is None else t.to(dev, copy=True)
                 for t in payload)


def _gather_tree(t, group: PodGroup):
    return tree.map(lambda x: group.all_gather(x, kind="all_gather").wait(),
                    t)


def gather_stream_state(state, group: PodGroup):
    """Inverse of ``shard_stream_state``, a collective: every rank calls
    it; rank 0 gets one full ``StreamState`` (per-replica leaves gathered
    in replica order, the shared ones its own, in-flight gathers waited
    for), the other ranks None. Counted as ``all_gather`` traffic, not
    wire."""
    from .streaming import StreamState
    st = state.base
    ist = st.inner_state
    saved, probe = dict(group.traffic), group.probe
    group.probe = None             # placement, not a round's collective
    reps = _gather_tree(st.replica_params, group)
    m, v = _gather_tree(ist.m, group), _gather_tree(ist.v, group)
    count = group.all_gather(torch.from_numpy(np.asarray(
        ist.count, np.int32)).to(group.device)).wait()
    master = None if ist.master is None else _gather_tree(ist.master,
                                                          group)
    residual = None if state.residual is None else \
        _gather_tree(state.residual, group)
    group.traffic = saved          # placement, not the transport's bill
    group.probe = probe
    inflight = None if state.inflight is None else tuple(
        None if slot is None else (resolve(slot[0]), slot[1])
        for slot in state.inflight)
    if group.rank != 0:
        return None
    base = st._replace(replica_params=reps, inner_state=ist._replace(
        m=m, v=v, count=count.cpu().numpy().astype(np.int32),
        master=master))
    return StreamState(base=base, pending=state.pending, armed=state.armed,
                       residual=residual, inflight=inflight)
