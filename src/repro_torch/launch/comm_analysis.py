"""Collective bytes, roofline terms and memory items of the dry run (the
JAX ``launch/hlo_analysis.py``), with the H100's constants.

The JAX package reads its collectives from post-SPMD HLO text. The port
has no HLO: it counts them where they are issued. Its cross-island
collectives are the calls of its pod group (``core/pod_collectives.
PodGroup``): ``CountingGroup`` is a ``PodGroup`` whose communication
methods record each call (op, bytes) and return tensors of the right
shape (meta tensors stay meta) without communicating: one rank's view of
a run whose ranks are DiLoCo islands. Every one of its bytes crosses
islands ("pods"), and, as ``PodGroup.traffic`` counts them, each is a
byte this rank hands to a collective: the tensor all-reduced, this rank's
band of an all-gather, the tensor sent in an exchange. The collectives
within an island (FSDP×TP of the dense and cross-attention families on
an island mesh of DTensors) are the functional collectives DTensor
issues, which ``launch/op_cost.py`` records per chip as a chip moves
them; the dry run adds them to the stats as intra-pod bytes
(``CollectiveStats.intra_pod_bytes``). The other families run unsharded
within an island, and their records say so.

Roofline terms (one NVIDIA H100 SXM5 per chip; data-sheet values):
    compute    = FLOPs / (chips × 989.4e12 FLOP/s, bf16 dense)
    memory     = bytes / (chips × 3.35e12 B/s HBM3)
    collective = collective bytes per chip / link rate, all-reduce 2×
with NVLink (450e9 B/s per direction) inside an island and a modelled
cross-island network of one 400 Gb/s NDR port per card (50e9 B/s) unless
the caller names another rate.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.pod_collectives import OverlapProbe, PodGroup

# NVIDIA H100 SXM5 80GB, data sheet (dense rates, 700 W)
CARD = "NVIDIA H100 SXM5 80GB"
PEAK_BF16 = 989.4e12        # FLOP/s, tensor cores, dense
PEAK_TF32 = 494.7e12        # FLOP/s, tensor cores, dense
PEAK_F32 = 66.9e12          # FLOP/s outside the tensor cores
HBM_BW = 3.35e12            # bytes/s, HBM3
HBM_BYTES = 80e9            # bytes of HBM3
NVLINK_BW = 450e9           # bytes/s per direction, NVLink 4 (900 GB/s both)
# modelled: one 400 Gb/s NDR InfiniBand port per card between islands
CROSS_ISLAND_BW = 50e9

# the fragment syncs among the collectives (JAX's ``_SYNC_OPS``): the f32
# transport all-reduces, the quantized ones all-gather
_SYNC_OPS = ("all-reduce", "all-gather")


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int = 0
    cross_pod_bytes: int = 0
    intra_pod_bytes: int = 0
    by_op: dict = dataclasses.field(default_factory=dict)
    count: int = 0
    # pod-crossing traffic only, split by op
    cross_by_op: dict = dataclasses.field(default_factory=dict)
    cross_count_by_op: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, nbytes: int):
        """One pod-crossing call of ``op`` moving ``nbytes``."""
        self.total_bytes += nbytes
        self.cross_pod_bytes += nbytes
        self.count += 1
        self.by_op[op] = self.by_op.get(op, 0) + nbytes
        self.cross_by_op[op] = self.cross_by_op.get(op, 0) + nbytes
        self.cross_count_by_op[op] = self.cross_count_by_op.get(op, 0) + 1

    def as_dict(self):
        return {"total_bytes": self.total_bytes,
                "cross_pod_bytes": self.cross_pod_bytes,
                "intra_pod_bytes": self.intra_pod_bytes,
                "count": self.count, "by_op": dict(self.by_op),
                "cross_by_op": dict(self.cross_by_op),
                "cross_count_by_op": dict(self.cross_count_by_op)}


def roofline(flops: float, hbm_bytes: float, coll: CollectiveStats,
             *, chips: int, ici_bw: float = NVLINK_BW,
             dcn_bw: float = CROSS_ISLAND_BW, peak=PEAK_BF16,
             hbm=HBM_BW) -> dict:
    """Three roofline terms (seconds) + the dominant one, JAX's formula.

    flops / hbm_bytes are GLOBAL (whole-program) → divided over chips.
    Collective bytes are per device; an all-reduce of R bytes moves ≈2R
    per device over its links, every other collective ≈1R — so collective
    time needs NO further division. ``ici_bw`` is the link rate within an
    island (NVLink), ``dcn_bw`` between islands.

    The within-island term reads the stats' intra-pod bytes: the
    collectives DTensor issues on an island mesh (``op_cost``), which are
    already what a chip moves (an all-reduce's (n−1)/n of its tensor each
    way, so its 2× stays). A record whose family runs unsharded within an
    island shows the term, with ``intra_pod_bytes``, as None (not
    modelled, not 0).
    """
    compute_s = flops / (chips * peak)
    memory_s = hbm_bytes / (chips * hbm)

    def _wire(stats_bytes, by_op_share):
        ar = by_op_share.get("all-reduce", 0)
        other = stats_bytes - ar
        return 2.0 * ar + 1.0 * other

    # split by_op between intra/cross proportionally to their totals
    tot = max(coll.total_bytes, 1)
    intra_by = {k: v * coll.intra_pod_bytes / tot
                for k, v in coll.by_op.items()}
    cross_by = {k: v * coll.cross_pod_bytes / tot
                for k, v in coll.by_op.items()}
    intra_s = _wire(coll.intra_pod_bytes, intra_by) / ici_bw
    cross_s = _wire(coll.cross_pod_bytes, cross_by) / dcn_bw
    collective_s = intra_s + cross_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s, "collective_intra_s": intra_s,
             "collective_cross_s": cross_s}
    terms["bound"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["total_s"] = max(compute_s, memory_s, collective_s)
    return terms


def memory_budget() -> dict:
    """The card's memory: ``torch.cuda``'s total where a card is visible,
    else the H100's 80 GB, named."""
    if torch.cuda.is_available():
        return {"bytes": torch.cuda.get_device_properties(0).total_memory,
                "source": torch.cuda.get_device_name(0)}
    return {"bytes": int(HBM_BYTES), "source": f"{CARD} (data sheet)"}


def memory_items(argument_bytes: int, cost: dict, *,
                 batch_shards: int = 1) -> dict:
    """Per-device memory of one function from its dry run: arguments as
    laid out (``argument_bytes``, from the specs' shard bytes), the
    temporaries as the meta run's peak of live storage (``op_cost``'s
    ``peak_live_bytes``, the outputs alive at that peak included) and the
    outputs as what is live at its end, both divided by the mesh axes the
    batch is sharded over. ``peak_bytes_est`` = arguments + temporaries,
    held against the card's memory (``memory_budget``)."""
    temp = int(cost["peak_live_bytes"]) // batch_shards
    out = {"argument_size_in_bytes": int(argument_bytes),
           "output_size_in_bytes": int(cost["end_live_bytes"])
           // batch_shards,
           "temp_size_in_bytes": temp,
           "peak_bytes_est": int(argument_bytes) + temp}
    budget = memory_budget()
    out.update(budget_bytes=int(budget["bytes"]),
               budget_source=budget["source"],
               fits=out["peak_bytes_est"] <= budget["bytes"])
    return out


class _RoundProbe(OverlapProbe):
    """A counting group's overlap probe: the round calls ``at`` where it
    leaves its inner steps for its sync events, which also closes the
    group's inner step."""

    def __init__(self, group):
        super().__init__()
        self._group = group

    def at(self, round_: int, step: int):
        super().at(round_, step)
        self._group.in_step = False


class CountingGroup(PodGroup):
    """Rank ``rank`` of ``pods`` island ranks that records its collectives
    (``stats``, ``traffic``, ``events``) and communicates nothing: a
    gather returns an uninitialised (pods·k_loc, ...) tensor, an
    all-reduce leaves its tensor as it is, an exchange returns an
    uninitialised tensor like its input. ``decide`` returns this rank's
    own value and ``agree`` True. ``device`` is where it says the rank
    computes (meta for the dry run).

    Schedule: the caller marks each inner step with ``inner_step()`` (the
    dry run's loss does); the streaming round's probe (``track_overlap``)
    marks where the round leaves its inner steps for its sync events.
    ``events`` lists "compute" (an inner step) and "sync" (an all-reduce
    or all-gather: JAX's sync ops, metric means included) in issue order;
    a sync issued inside an inner step is counted in
    ``syncs_inside_compute``."""

    def __init__(self, rank: int = 0, pods: int = 2, *, device="meta"):
        super().__init__(rank, pods, device=device, backend="counting")
        self.stats = CollectiveStats()
        self.events: list = []
        self.by_sync_op: dict = {}
        self.in_step = False
        self.syncs_inside_compute = 0

    def track_overlap(self):
        """Install the overlap probe (before the round is built)."""
        self.probe = _RoundProbe(self)
        return self

    def inner_step(self):
        self.events.append("compute")
        self.in_step = True

    def _call(self, op: str, t):
        self.stats.add(op, t.numel() * t.element_size())
        if op in _SYNC_OPS:
            self.events.append("sync")
            self.by_sync_op[op] = self.by_sync_op.get(op, 0) + 1
            self.syncs_inside_compute += self.in_step

    def _all_reduce(self, src):
        self._call("all-reduce", src)

    def _all_gather(self, out, src, async_op: bool):
        self._call("all-gather", src)

    def _exchange(self, src, recv, partner: int):
        self._call("collective-permute", src)

    def barrier(self):
        self.traffic["control"] += 1

    def decide(self, value: int) -> int:
        self.traffic["control"] += 1
        self.traffic["control_bytes"] += 8
        self.stats.add("collective-broadcast", 8)
        return int(value)

    def agree(self, data: bytes) -> bool:
        self.all_gather(torch.empty((1, 32), dtype=torch.uint8,
                                    device=self.device), kind="control",
                        bill="control_bytes")
        return True


def stream_interleaving(group: CountingGroup) -> dict:
    """The streaming round's schedule as issued (the JAX
    ``stream_interleaving``, read from the order of the calls instead of
    HLO text): ``pod_collectives`` wire syncs (``sync_by_op``; the f32
    transport all-reduces, the quantized ones all-gather), the inner steps
    (``compute_events``), the syncs with an inner step after them, and
    those issued inside an inner step (must be 0)."""
    ev = group.events
    last_compute = max((i for i, e in enumerate(ev) if e == "compute"),
                       default=-1)
    syncs = [i for i, e in enumerate(ev) if e == "sync"]
    return {"computation": "stream_round",
            "pod_collectives": len(syncs),
            "pod_all_reduces": group.by_sync_op.get("all-reduce", 0),
            "sync_by_op": dict(group.by_sync_op),
            "compute_events": ev.count("compute"),
            "syncs_with_compute_after": sum(i < last_compute
                                            for i in syncs),
            "syncs_inside_compute": group.syncs_inside_compute}


def wire_profile(group: CountingGroup, *, chips_per_pod: int | None = None,
                 interleaving: bool = True, tau: int | None = None) -> dict:
    """Manifest-ready wire profile of one dry-run function: the collective
    byte totals, the schedule's interleaving and, where the group's
    overlap probe saw collectives, their issue→consume ``overlap``
    (``OverlapProbe.overlap``)."""
    prof = {"chips_per_pod": chips_per_pod,
            "collectives": group.stats.as_dict()}
    if interleaving:
        prof["interleaving"] = stream_interleaving(group)
    if group.probe is not None and group.probe.rows:
        prof["overlap"] = group.probe.overlap(tau)
    return prof
