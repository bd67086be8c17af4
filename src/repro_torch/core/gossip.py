"""Gossip outer sync: NoLoCo-style pairwise partial averaging (cf. arXiv
2506.10911), as the JAX ``core/gossip.py``: the transport with NO
collective that spans all k workers.

  * every worker keeps its OWN estimate g_i of the global parameters and
    its own outer Nesterov state;
  * each round, the worker applies its own outer gradient d_i = g_i − θ_i
    through its own momentum buffer: a local update, no wire at all;
  * the only communication is ONE pairwise exchange per worker per round:
    i receives partner j's fresh estimate and partially adopts it on the
    round's scheduled fragment, g_i ← g_i + mix · mask_p · (g_j − g_i), so
    per-round wire bytes are fragment-sized and point-to-point.

Pairings (``dcfg.gossip_pairing``):

  butterfly  partner(i, t) = i XOR 2^(t mod log2 k): pairwise exchanges
             along hypercube dimensions; with mix=0.5 and a full-tree
             fragment, log2 k consecutive rounds mix any disagreement to
             the exact mean. Needs k a power of 2.
  random     a fresh uniform perfect matching each round (odd k leaves one
             worker unpaired). Where JAX draws the permutation from a
             ``jax.random`` key folded from the round's key, the port
             draws it from a ``torch.Generator`` seeded from (seed,
             ``PAIR_FOLD``, round t) (``pair_seed``): the token stream is
             the same under both pairings, a resumed run draws the same
             pairings with nothing added to its snapshot, and
             ``pairing_edges`` rebuilds exactly the edges the exchange
             used.

With ``streaming_fragments = P > 1`` round t exchanges only fragment
(t mod P) (``core/fragments.py``). The exchanged payload takes a
quantize→dequantize round trip at ``outer_grad_dtype`` (float32 or
bfloat16; ``ops.quant_roundtrip``, one ``fake_quant`` launch per leaf on
the stacked (k, ...) estimates under a kernel mode); int4 is refused.

The local outer update runs through ``outer_opt.update`` on the stacked
(k, ...) leaves at once: for Nesterov under a kernel mode one
``outer_nesterov`` launch per leaf. The update is elementwise with scalar
hyper-parameters, so this equals JAX's ``vmap`` over workers bit for bit;
an inactive worker's estimate and buffers are put back afterwards. The
other outer optimizers (whose Adam bias corrections depend on each
worker's own count) update worker by worker.

Fault semantics (``core/faults.py`` round projections): drop_mask[i] = 0
cuts worker i's link this round (every pair containing i skips its
exchange; i's local update still applies); active_mask[i] = 0 preempts
worker i (no inner steps, no local update, no exchange for its pairs).

The round has ``diloco.make_round``'s signature and is built by it for
``transport="gossip"``; ``GossipState.global_params`` (the mean of the k
estimates) serves the drivers' eval hooks.
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import tree
from ..configs.base import DiLoCoConfig, TrainConfig
from ..kernels import ops as kops
from ..optim import adamw, precision
from . import diloco, fragments, outer_opt, pod_collectives


class GossipState(NamedTuple):
    """Gossip carry. Leaves of global_est / outer_state / replica_* all
    lead with the (k,) worker axis: there is no single global copy, only k
    estimates (``global_params`` exposes their mean for eval and
    checkpoint readers). ``outer_state.count`` is a (k,) int32 host
    array; ``outer_t`` and ``inner_steps_done`` are host integers."""
    global_est: Any                     # (k, ...) per-worker estimate g_i
    outer_state: outer_opt.OuterState   # (k, ...) leaves, (k,) count
    replica_params: Any                 # (k, ...) working params θ_i
    inner_state: adamw.AdamWState       # (k, ...) AdamW moments (+ master)
    outer_t: int                        # round counter (drives the pairing)
    inner_steps_done: int

    @property
    def global_params(self):
        """The consensus estimate: the mean over workers."""
        return tree.map(lambda g: g.mean(dim=0), self.global_est)


def validate(dcfg: DiLoCoConfig):
    """The JAX module's refusals, with its messages."""
    k = dcfg.k
    if dcfg.gossip_pairing not in ("butterfly", "random"):
        raise ValueError(
            f"gossip_pairing must be butterfly|random, got "
            f"{dcfg.gossip_pairing!r}")
    if dcfg.gossip_pairing == "butterfly" and k & (k - 1):
        raise ValueError(
            f"butterfly pairing needs k a power of 2, got k={k} "
            "(use gossip_pairing='random')")
    if not 0.0 <= dcfg.gossip_mix <= 1.0:
        raise ValueError(f"gossip_mix must be in [0,1], got "
                         f"{dcfg.gossip_mix}")
    if dcfg.outer_grad_dtype == "int4":
        raise ValueError(
            "gossip exchanges absolute parameter estimates, not "
            "zero-centered outer gradients: int4 transport is not "
            "meaningful here (use float32 or bfloat16)")
    if dcfg.error_feedback:
        raise ValueError(
            "error_feedback applies to quantized outer-gradient "
            "transports; the gossip exchange has no residual to carry")
    if dcfg.prune_frac > 0:
        raise ValueError("prune_frac is not supported on the gossip "
                         "transport (deltas never cross the wire)")


def init_state(params, dcfg: DiLoCoConfig) -> GossipState:
    """Start gossip DiLoCo from float32 ``params`` (cf.
    ``diloco.init_state``): every worker begins with the same estimate,
    zero outer buffers and zero disagreement."""
    validate(dcfg)
    base = diloco.init_state(params, dcfg)
    k = dcfg.k
    stack = lambda p: p.unsqueeze(0).expand(k, *p.shape).clone()
    zeros = lambda p: torch.zeros((k,) + tuple(p.shape), dtype=p.dtype,
                                  device=p.device)
    return GossipState(
        global_est=tree.map(stack, params),
        outer_state=outer_opt.OuterState(
            tree.map(zeros, params), tree.map(zeros, params),
            np.zeros((k,), np.int32)),
        replica_params=base.replica_params,
        inner_state=base.inner_state,
        outer_t=0,
        inner_steps_done=0)


# ---------------------------------------------------------------------------
# pairing + mixing
# ---------------------------------------------------------------------------

# tag folded into the pairing's seed (the JAX module folds it into the
# round's key): the round body and ``pairing_edges`` derive the same
# permutation from it
PAIR_FOLD = 0x90551b


def pair_seed(seed: int, t: int) -> int:
    """The seed of round ``t``'s random matching: a digest of (``seed``,
    ``PAIR_FOLD``, t)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, PAIR_FOLD, int(t)])
    return int(ss.generate_state(1, np.uint64)[0])


def random_perm(k: int, seed: int, t: int) -> np.ndarray:
    """The (k,) permutation round ``t``'s random matching pairs along."""
    gen = torch.Generator().manual_seed(pair_seed(seed, t))
    return torch.randperm(k, generator=gen).numpy().astype(np.int32)


def partner_map(k: int, t: int, pairing: str, *, seed: int = 0,
                perm=None) -> np.ndarray:
    """(k,) int32 partner indices for round ``t``, a host array. An
    involution: partner[partner[i]] == i, with partner[i] == i meaning
    "sit out" (k=1, or the odd worker of a random matching). Random
    pairing pairs consecutive entries of ``perm`` (default: ``random_perm
    (k, seed, t)``), as the JAX function pairs its key's permutation."""
    if k == 1:
        return np.zeros((1,), np.int32)
    idx = np.arange(k, dtype=np.int32)
    if pairing == "butterfly":
        L = k.bit_length() - 1              # log2(k), k a power of 2
        return idx ^ np.int32(1 << (int(t) % L))
    if pairing == "random":
        perm = (random_perm(k, seed, t) if perm is None
                else np.asarray(perm, np.int32))
        m = k // 2
        partner = idx.copy()                 # odd worker: self
        partner[perm[0:2 * m:2]] = perm[1:2 * m:2]
        partner[perm[1:2 * m:2]] = perm[0:2 * m:2]
        return partner
    raise ValueError(pairing)


def edges_of(partner) -> tuple:
    """Sorted (i, j) pairs with i < j of a partner map (self-paired
    workers sit out)."""
    pm = np.asarray(partner)
    return tuple(sorted({(min(i, int(pm[i])), max(i, int(pm[i])))
                         for i in range(len(pm)) if int(pm[i]) != i}))


def pairing_edges(k: int, t: int, pairing: str, *, seed: int = 0,
                  perm=None) -> tuple:
    """Host-side view of round ``t``'s exchange graph: the edges of
    ``partner_map(k, t, pairing, seed=seed, perm=perm)``, the map the
    round body draws with the same ``seed``."""
    return edges_of(partner_map(k, t, pairing, seed=seed, perm=perm))


def mix_round(est, partner, mask_tree, *, mix: float, ok=None,
              quant_dtype: str = "float32", kernel_mode: str = "auto"):
    """One pairwise partial-averaging exchange on a (k, ...) estimate
    tree: every worker adopts ``mix`` of its partner's (transport-
    quantized) estimate on the masked region,

        g_i ← g_i + mix · ok_i · mask · (Q(g_partner[i]) − g_i),

    in the JAX expression's order (bit for bit at float32). ``partner``:
    (k,) ints; ``ok`` (k,) float gates each exchange (drop/inactive
    endpoints); ``mask_tree`` restricts it to the scheduled fragment
    (per-leaf masks broadcastable against a leaf without its worker axis,
    as ``fragments.partition_params`` gives them). Returns a new tree."""
    leaves = tree.leaves(est)
    k = leaves[0].shape[0]
    dev = leaves[0].device
    ok = np.ones((k,), np.float32) if ok is None else np.asarray(
        ok, np.float32)
    partner = np.asarray(partner, np.int64)
    gate = ok * (partner != np.arange(k)).astype(np.float32)
    gate_t = torch.from_numpy(gate).to(dev)
    part_t = torch.from_numpy(partner).to(dev)

    def leaf(g, m):
        payload = g
        if quant_dtype != "float32":
            payload = kops.quant_roundtrip(g, quant_dtype, mode=kernel_mode,
                                           stacked=True)
        recv = payload.index_select(0, part_t)
        sel = gate_t.reshape((k,) + (1,) * (g.dim() - 1))
        m = torch.as_tensor(np.asarray(m, np.float32), device=dev).to(
            g.dtype).expand(g.shape[1:])
        return g + mix * sel * m[None] * (recv - g)

    return tree.map(leaf, est, mask_tree)


def pod_mix_round(est_band, partner, mask_tree, *, mix: float, group,
                  ok=None, quant_dtype: str = "float32",
                  kernel_mode: str = "auto"):
    """``mix_round`` on a pod group: this rank holds the band [r·k_loc,
    (r+1)·k_loc) of the (k, ...) estimates, k_loc = k / pods, and the
    partners' (transport-quantized) estimates arrive by
    ``group.exchange``: ONE exchange a leaf with the rank holding the
    partner band (a point-to-point collective-permute, no collective over
    all pods), none where the partners lie in the rank's own band. The
    partner map must send the band to one band, as a butterfly stage
    does. Returns this rank's band of ``mix_round``'s result, bit for
    bit."""
    leaves = tree.leaves(est_band)
    k_loc, dev = leaves[0].shape[0], leaves[0].device
    partner = np.asarray(partner, np.int64)
    k = partner.shape[0]
    pod_collectives.check_bands(k, group.pods)
    r0 = pod_collectives.local_band(k_loc, group.rank)
    band = partner[r0:r0 + k_loc]
    peer = int(band[0]) // k_loc
    if (band // k_loc != peer).any():
        raise ValueError(f"rank {group.rank}'s partners {band.tolist()} "
                         "span several bands: a pod exchange needs a "
                         "band-to-band partner map (a butterfly stage)")
    ok = np.ones((k,), np.float32) if ok is None else np.asarray(
        ok, np.float32)
    gate = (ok * (partner != np.arange(k)).astype(np.float32))[
        r0:r0 + k_loc]
    gate_t = torch.from_numpy(gate).to(dev)
    idx_t = torch.from_numpy(band - peer * k_loc).to(dev)

    def leaf(g, m):
        payload = g
        if quant_dtype != "float32":
            payload = kops.quant_roundtrip(g, quant_dtype, mode=kernel_mode,
                                           stacked=True)
        recv = group.exchange(payload, peer).index_select(0, idx_t)
        sel = gate_t.reshape((k_loc,) + (1,) * (g.dim() - 1))
        m = torch.as_tensor(np.asarray(m, np.float32), device=dev).to(
            g.dtype).expand(g.shape[1:])
        return g + mix * sel * m[None] * (recv - g)

    return tree.map(leaf, est_band, mask_tree)


def butterfly_swap(stage: int, k: int):
    """The butterfly stage-``stage`` exchange (i XOR 2^stage) as a
    reshape and flip of the worker axis: the same result as indexing by
    ``partner_map(k, stage, 'butterfly')``."""
    B = 1 << int(stage)
    if k % (2 * B):
        raise ValueError(f"stage {stage} needs 2^{int(stage) + 1} | k, "
                         f"got k={k}")

    def swap(g):
        r = g.reshape((k // (2 * B), 2, B) + tuple(g.shape[1:]))
        return torch.flip(r, dims=(1,)).reshape(g.shape)

    return swap


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def _local_outer_update(deltas, est, ostate, dcfg, active, mode):
    """Every active worker's own outer step: ``est`` ← OuterOpt(``est``,
    ``deltas``) through its own buffers. Returns (estimates, OuterState);
    an inactive worker keeps its estimate, buffers and count."""
    k = dcfg.k
    hp = dict(kind=dcfg.outer_opt, lr=dcfg.outer_lr,
              momentum=dcfg.outer_momentum, b2=dcfg.outer_adam_b2,
              eps=dcfg.outer_adam_eps, kernel_mode=mode)
    act = np.asarray(active, np.float32) > 0
    count = np.where(act, np.asarray(ostate.count, np.int32) + 1,
                     ostate.count).astype(np.int32)
    if dcfg.outer_opt == "nesterov":
        # the stacked leaves at once (no count in the update); inactive
        # workers' slices are put back afterwards
        idle = torch.from_numpy(np.flatnonzero(~act)).to(
            tree.leaves(est)[0].device)
        old = [tree.map(lambda x: x.index_select(0, idle), t)
               for t in (est, ostate.buf)] if len(idle) else None
        est, new = outer_opt.update(deltas, ostate._replace(count=0), est,
                                    **hp)
        if old is not None:
            for cur, keep in zip((est, new.buf), old):
                for c, kp in zip(tree.leaves(cur), tree.leaves(keep)):
                    c.index_copy_(0, idle, kp)
        return est, outer_opt.OuterState(new.buf, new.buf2, count)
    # the other optimizers worker by worker, each with its own count
    for i in np.flatnonzero(act):
        sl = lambda t: tree.map(lambda x: x[i], t)
        outer_opt.update(sl(deltas), outer_opt.OuterState(
            sl(ostate.buf), sl(ostate.buf2), int(ostate.count[i])),
            sl(est), **hp)
    return est, outer_opt.OuterState(ostate.buf, ostate.buf2, count)


def make_gossip_round_body(loss_fn, sample_fn, dcfg: DiLoCoConfig,
                           tcfg: TrainConfig, *, total_steps=None,
                           compute_cosine: bool = False, batch_size=None,
                           seq_len=None, group=None,
                           partner_fn: Callable | None = None):
    """The gossip round, with ``diloco.make_round``'s signature:
    round(GossipState, gen, drop_mask, active_mask, weights) ->
    (GossipState, metrics). ``weights`` is accepted and ignored: there is
    no global average to weight. The round draws its tokens as the
    classic round does (one ``sample_fn(gen, H·B, S)`` call); the inner
    phase updates the replicas in place; the estimates are replaced.

    ``partner_fn(t) -> (k,) ints`` gives round t's partner map (default:
    ``partner_map(k, t, dcfg.gossip_pairing, seed=tcfg.seed)``). Metrics
    as the JAX round's, plus the host seconds spent sampling
    (``sample_s``), in the inner phase (``inner_s``) and in the outer
    update and exchange (``outer_s``). ``group`` must be None: the gossip
    round runs replica-stacked in one process."""
    del compute_cosine
    validate(dcfg)
    if group is not None:
        raise ValueError(
            "transport='gossip' runs replica-stacked (simulated) in one "
            "process; drop group=")
    if precision.policy_of(dcfg) != precision.policy_of(tcfg):
        raise ValueError(
            "DiLoCoConfig and TrainConfig precision policies disagree")
    inner_step = diloco.make_inner_step(loss_fn, tcfg, total_steps)
    B = batch_size or tcfg.batch_size
    S = seq_len or tcfg.seq_len
    k, H = dcfg.k, dcfg.H
    P = max(1, int(dcfg.streaming_fragments))
    mode = dcfg.kernel_mode
    if partner_fn is None:
        partner_fn = lambda t: partner_map(k, t, dcfg.gossip_pairing,
                                           seed=tcfg.seed)
    masks: list = []        # per fragment, the partition's per-leaf masks

    def round_body(state: GossipState, gen, drop_mask=None,
                   active_mask=None, weights=None):
        del weights
        ones = np.ones((k,), np.float32)
        drop = ones if drop_mask is None else np.asarray(drop_mask,
                                                         np.float32)
        act = ones if active_mask is None else np.asarray(active_mask,
                                                          np.float32)
        est = state.global_est
        dev = tree.leaves(est)[0].device
        if not masks:
            example = tree.map(lambda g: g[0], est)
            masks.extend(fragments.partition_params(
                example, P, overrides=dcfg.stream_overrides).masks)
        t0 = time.perf_counter()
        toks = sample_fn(gen, H * B, S)[:k].reshape(k, H, B, S)
        diloco._sync(dev)
        t1 = time.perf_counter()
        rp, is_, ms = diloco.inner_phase(
            inner_step, state.replica_params, state.inner_state,
            {"tokens": toks}, state.inner_steps_done, active_mask=act)
        diloco._sync(dev)
        t2 = time.perf_counter()

        # local outer update: d_i = g_i − θ_i through worker i's own
        # state, full weight (mixing spreads each worker's evidence)
        masters = is_.master
        src = masters if masters is not None else rp
        with torch.no_grad():
            deltas = tree.map(lambda g, r: g - r.to(g.dtype), est, src)
            new_g = tree.map(torch.clone, est)
            new_g, new_outer = _local_outer_update(
                deltas, new_g, state.outer_state, dcfg, act, mode)

            # the exchange: the partner's fresh estimate on the round's
            # fragment
            partner = np.asarray(partner_fn(state.outer_t), np.int64)
            comm = drop * act
            ok = comm * comm[partner]
            frag = state.outer_t % P
            mixed = mix_round(new_g, partner, masks[frag],
                              mix=dcfg.gossip_mix, ok=ok,
                              quant_dtype=dcfg.outer_grad_dtype,
                              kernel_mode=mode)
            del new_g

            # re-dispatch: active workers adopt their own mixed estimate
            # (copy_ rounds it to the working dtype; masters take it as
            # it is)
            targets = [rp] + ([] if masters is None else [masters])
            for i in np.flatnonzero(act > 0):
                for dst in targets:
                    for g, r in zip(tree.leaves(mixed), tree.leaves(dst)):
                        r[i].copy_(g[i])

            consensus = tree.map(lambda g: g.mean(dim=0), mixed)
            spread = diloco._tree_norm(tree.map(
                lambda g, c: g - c[None], mixed, consensus))
            gnorm = diloco._tree_norm(tree.map(lambda d: d.mean(dim=0),
                                               deltas))
        diloco._sync(dev)
        metrics = {
            "inner_loss": ms["loss"].mean(),
            "inner_loss_last": ms["loss"][:, -1].mean(),
            "outer_gnorm": gnorm,
            "drop_frac": float(np.float32(1.0) - drop.mean()),
            "gossip_spread": spread,
            "gossip_frag": float(frag),
            "exchange_frac": float(ok.mean()),
            "sample_s": t1 - t0, "inner_s": t2 - t1,
            "outer_s": time.perf_counter() - t2,
        }
        return GossipState(
            global_est=mixed, outer_state=new_outer, replica_params=rp,
            inner_state=is_, outer_t=state.outer_t + 1,
            inner_steps_done=state.inner_steps_done + H), metrics

    return round_body


def frag_bytes(params, dcfg: DiLoCoConfig) -> list:
    """Per-fragment exchange bytes one worker RECEIVES per round (the
    partner's estimate restricted to the scheduled fragment, at the
    transport dtype)."""
    P = max(1, int(dcfg.streaming_fragments))
    part = fragments.partition_params(params, P,
                                      overrides=dcfg.stream_overrides)
    return [kops.transport_bytes(int(n), dcfg.outer_grad_dtype)
            for n in part.sizes]
