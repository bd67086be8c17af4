"""Mixture-of-Experts FFN (the JAX ``models/moe.py``): a token-choice top-k
router, capacity-bounded dispatch into an (E, C, D) buffer, optional
shared experts (DeepSeek-V2 style) and the Switch load-balancing loss.

The dispatch is the JAX package's, op for op: top-k by K argmax sweeps
(the first index wins a tie; each pick subtracts one_hot · 1e9), ranks
within an expert by a cumsum over the token-major t·K + k assignment
order, and assignments past an expert's capacity C land in an overflow
row E·C that is discarded (dropped). ``_dispatch_group`` is looked up at
call time, so a caller can wrap it to count the drops. The router's
product accumulates bf16 operands in float32 (``layers.f32_product``), as
JAX's ``preferred_element_type`` does: its probabilities decide top-k.

On an island's DTensors (``_apply_moe_on_mesh``) the dispatch is laid out
at JAX's three constrain sites: the grouped tokens (G, Tg, D) over "data"
(each data rank's own groups, its own batch rows with their features
gathered), the (G, E, C, D) buffer's experts over "model", the experts'
output back over "data" alone (an all-gather over "model": the grouped
tokens are whole on every rank of "model", so nothing calls for an
all-to-all). Between them the router's softmax, top-k, the dispatch
(one-hot, cumsum, ``index_copy``) and the combine (``gather`` by slot)
run on each rank's own groups as plain tensors (DTensor has no sharding
rule for them), marked for the dry run's counts (``spec.mark_local``);
the router and the experts are DTensor products, the experts' weights
read with their FSDP shards gathered.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.spec import constrain, from_block, is_dtensor, mark_local
from . import layers as L
from .layers import _act, dense_init


MOE_AXES = {"router": ("embed", None),
            "w_up": ("experts", "embed", None),
            "w_gate": ("experts", "embed", None),
            "w_down": ("experts", None, "embed"),
            "shared": L.MLP_AXES}


def init_moe(gen, cfg, *, device, lead=()):
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    init = lambda shape: dense_init(gen, shape, cfg.init_scale,
                                    device=device, lead=lead)
    p = {"router": init((D, E)), "w_up": init((E, D, Fd)),
         "w_gate": init((E, D, Fd)), "w_down": init((E, Fd, D))}
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fd
        p["shared"] = {"w_up": init((D, Fs)), "w_gate": init((D, Fs)),
                       "w_down": init((Fs, D))}
    return p


def _capacity(tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = math.ceil(tokens * top_k * cf / n_experts)
    return max(8, (c + 7) // 8 * 8)


def _topk_iterative(probs, K: int):
    """(values, indices) of the K largest along the last dim by K argmax
    sweeps: the first index wins a tie, and each pick is pushed down by
    subtracting one_hot · 1e9 (not masked), as in the JAX package.
    Gradients flow through ``probs`` at the picked indices."""
    p = probs
    vals, idxs = [], []
    for _ in range(K):
        i = torch.argmax(p, dim=-1)
        vals.append(torch.gather(p, -1, i[..., None])[..., 0])
        idxs.append(i)
        p = p - F.one_hot(i, p.shape[-1]).to(p.dtype) * 1e9
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def _dispatch_group(x, probs, idx, E: int, C: int):
    """One group's tokens into an (E·C + 1, D) buffer by expert.

    x: (T, D); probs, idx: (T, K). Returns (buffer, slot, keep): slot
    (T, K) the row of each assignment in the buffer (E·C = dropped), keep
    (T, K) bool."""
    T, K = idx.shape
    e_flat = idx.reshape(-1)                                   # (T·K,)
    oh = F.one_hot(e_flat, E).to(torch.int32)                  # (TK, E)
    # rank of assignment j within its expert = the earlier assignments
    # of the same expert
    rank = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
    pos = (rank * oh).sum(-1)                                  # (TK,)
    keep_flat = pos < C
    slot = torch.where(keep_flat, e_flat * C + pos,
                       torch.full_like(e_flat, E * C))
    tok = torch.arange(T * K, device=x.device) // K
    buffer = x.new_zeros((E * C + 1, x.shape[-1])).index_copy(
        0, slot, x[tok])
    return buffer, slot.reshape(T, K), keep_flat.reshape(T, K)


def apply_moe(p, x, cfg, *, groups: int = 1):
    """x: (B, S, D) -> (out, aux loss). ``groups``: the static token
    grouping (capacity is per group), 1 unless a caller asks (the data
    axis's size on an island)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = math.gcd(T, max(groups, 1))
    Tg = T // G
    dt = x.dtype
    C = _capacity(Tg, K, E, cfg.capacity_factor)
    if is_dtensor(x):
        return _apply_moe_on_mesh(p, x, cfg, G, Tg, C)
    xf = x.reshape(G, Tg, D)
    L._count(4)                 # the router and the experts' three products
    logits = L.f32_product("gtd,de->gte", xf, p["router"].to(dt))
    probs, top_p, top_i, buffer, slot, keep = _route(xf, logits, K, E, C)
    xb = buffer[:, :E * C].reshape(G, E, C, D)
    yb = _experts(p, xb, cfg)
    y = _combine(yb, slot, top_p, keep)
    if "shared" in p:
        y = y + _shared(p["shared"], xf, cfg)

    # load-balancing aux loss (Switch-style)
    frac = F.one_hot(top_i, E).float().mean(dim=(0, 1, 2))     # (E,)
    mean_p = probs.mean(dim=(0, 1))
    aux = E * (frac * mean_p).sum()
    return y.reshape(B, S, D), aux


def _route(xf, logits, K: int, E: int, C: int):
    """The router's softmax, top-k and each group's dispatch of ``xf`` (G,
    Tg, D) by its float32 ``logits`` (G, Tg, E): (probs, top_p, top_i,
    buffer (G, E·C + 1, D), slot, keep)."""
    probs = torch.softmax(logits, dim=-1)                      # (G, Tg, E)
    top_p, top_i = _topk_iterative(probs, K)                   # (G, Tg, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    bufs, slots, keeps = zip(*(_dispatch_group(xf[g], top_p[g], top_i[g],
                                               E, C)
                               for g in range(xf.shape[0])))
    buffer, slot, keep = (torch.stack(t) for t in (bufs, slots, keeps))
    return probs, top_p, top_i, buffer, slot, keep


def _experts(p, xb, cfg):
    """The experts' gated MLP on the (G, E, C, D) buffer. On an island
    mesh each weight is read with its FSDP shards gathered (the experts
    stay over "model"), as GSPMD gathers a weight for its product: left to
    itself, DTensor would gather the far larger buffer over "data"
    instead, to contract over the weights' data-sharded features."""
    dt = xb.dtype
    w = {n: constrain(p[n].to(dt), ("model", None, None))
         for n in ("w_up", "w_gate", "w_down")}
    up = torch.einsum("gecd,edf->gecf", xb, w["w_up"])
    gate = torch.einsum("gecd,edf->gecf", xb, w["w_gate"])
    h = _act(gate, cfg.act) * up
    return torch.einsum("gecf,efd->gecd", h, w["w_down"])


def _combine(yb, slot, top_p, keep):
    """Each assignment's expert output from ``yb`` (G, E, C, D) by its
    ``slot`` (the overflow row E·C reads zeros), weighted by its kept
    probability and summed over K: (G, Tg, D)."""
    G, E, C, D = yb.shape
    Tg, K = slot.shape[1:]
    yb = torch.cat([yb.reshape(G, E * C, D), yb.new_zeros((G, 1, D))], 1)
    y_asn = torch.gather(yb, 1, slot.reshape(G, Tg * K, 1).expand(
        G, Tg * K, D)).reshape(G, Tg, K, D)
    w = (top_p * keep).to(yb.dtype)
    return torch.einsum("gtkd,gtk->gtd", y_asn, w)


def _shared(sp, xf, cfg):
    """The shared experts' gated MLP on every token of ``xf``."""
    dt = xf.dtype
    L._count(3)
    hu = xf @ sp["w_up"].to(dt)
    hg = xf @ sp["w_gate"].to(dt)
    return (_act(hg, cfg.act) * hu) @ sp["w_down"].to(dt)


def _apply_moe_on_mesh(p, x, cfg, G: int, Tg: int, C: int):
    """``apply_moe`` of an island's DTensor ``x``, laid out as JAX's three
    constrain sites lay out the dispatch: the grouped tokens over "data"
    (each data rank's own groups: its own batch rows, the features
    gathered), the (G, E, C, D) buffer's experts over "model", the
    experts' output back over "data" alone. The router runs as a DTensor
    product, the softmax, top-k, dispatch and combine on each rank's own
    groups (no rank reads another's; the ranks of "model" repeat them),
    counted for every block they stand for (``spec.mark_local``). A
    grouping that the data axis does not divide runs replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    dt = x.dtype
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    n_data = mesh.size(names.index("data")) if "data" in names else 1
    xd = constrain(x, ("data" if G % n_data == 0 else None, None, None))
    pl = xd.placements
    grouped = (G, Tg, D)
    xf = from_block(xd.to_local().reshape(-1, Tg, D), mesh, pl, grouped)
    L._count(4)
    # the router's (D, E) weight whole on every rank (a small gather):
    # the logits of each rank's groups need no reduction
    router = constrain(p["router"].to(dt), (None, None))
    logits = constrain(L.f32_product("gtd,de->gte", xf, router),
                       _spec_of(pl, names, 3))
    xl, ll = mark_local(xf, xf.to_local(), logits.to_local())
    probs, top_p, top_i, buffer, slot, keep = _route(xl, ll, K, E, C)
    Gl = xl.shape[0]
    xb = from_block(buffer[:, :E * C].reshape(Gl, E, C, D), mesh, pl,
                    (G, E, C, D))
    xb = constrain(xb, ("data", "model", None, None))
    yb = constrain(_experts(p, xb, cfg), _spec_of(pl, names, 4))
    ybl, = mark_local(yb, yb.to_local())
    y = from_block(_combine(ybl, slot, top_p, keep), mesh, pl, grouped)
    if "shared" in p:
        y = y + _shared(p["shared"], xf, cfg)
    y = constrain(y, _spec_of(pl, names, 3))
    out = from_block(y.to_local().reshape(-1, S, D), mesh, pl, (B, S, D))

    # the aux loss's sums over each rank's groups, summed over "data"
    part = [Partial() if q.is_shard() else Replicate() for q in pl]
    whole = [Replicate()] * mesh.ndim
    fsum = F.one_hot(top_i, E).float().sum(dim=(0, 1, 2))
    psum = probs.sum(dim=(0, 1))
    fsum, psum = (DTensor.from_local(t, mesh, part, run_check=False)
                  .redistribute(mesh, whole) for t in (fsum, psum))
    frac = fsum / (G * Tg * K)
    mean_p = psum / (G * Tg)
    return out, E * (frac * mean_p).sum()


def _spec_of(pl, names, ndim: int) -> tuple:
    """The spec of an ``ndim`` tensor whose dim 0 lies as placements
    ``pl`` put dim 0 (the grouped tokens' layout), the rest whole."""
    axes = tuple(a for a, q in zip(names, pl) if q.is_shard(0))
    return ((axes if len(axes) > 1 else axes[0]) if axes else None,) \
        + (None,) * (ndim - 1)
