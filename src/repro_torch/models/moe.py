"""Mixture-of-Experts FFN (the JAX ``models/moe.py``): a token-choice top-k
router, capacity-bounded dispatch into an (E, C, D) buffer, optional
shared experts (DeepSeek-V2 style) and the Switch load-balancing loss.

The dispatch is the JAX package's, op for op: top-k by K argmax sweeps
(the first index wins a tie; each pick subtracts one_hot · 1e9), ranks
within an expert by a cumsum over the token-major t·K + k assignment
order, and assignments past an expert's capacity C land in an overflow
row E·C that is discarded (dropped). ``_dispatch_group`` is looked up at
call time, so a caller can wrap it to count the drops.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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
    grouping (capacity is per group), 1 unless a caller asks."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = math.gcd(T, max(groups, 1))
    Tg = T // G
    dt = x.dtype
    xf = x.reshape(G, Tg, D)
    L._count(4)                 # the router and the experts' three products
    logits = torch.einsum("gtd,de->gte", xf, p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                      # (G, Tg, E)
    top_p, top_i = _topk_iterative(probs, K)                   # (G, Tg, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    C = _capacity(Tg, K, E, cfg.capacity_factor)
    bufs, slots, keeps = zip(*(_dispatch_group(xf[g], top_p[g], top_i[g],
                                               E, C) for g in range(G)))
    buffer, slot, keep = (torch.stack(t) for t in (bufs, slots, keeps))
    xb = buffer[:, :E * C].reshape(G, E, C, D)
    up = torch.einsum("gecd,edf->gecf", xb, p["w_up"].to(dt))
    gate = torch.einsum("gecd,edf->gecf", xb, p["w_gate"].to(dt))
    h = _act(gate, cfg.act) * up
    yb = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    yb = torch.cat([yb.reshape(G, E * C, D), yb.new_zeros((G, 1, D))], 1)

    # combine: each assignment's output, weighted, summed over K
    y_asn = torch.gather(yb, 1, slot.reshape(G, Tg * K, 1).expand(
        G, Tg * K, D)).reshape(G, Tg, K, D)
    w = (top_p * keep).to(dt)
    y = torch.einsum("gtkd,gtk->gtd", y_asn, w)

    if "shared" in p:
        sp = p["shared"]
        L._count(3)
        hu = xf @ sp["w_up"].to(dt)
        hg = xf @ sp["w_gate"].to(dt)
        y = y + (_act(hg, cfg.act) * hu) @ sp["w_down"].to(dt)

    # load-balancing aux loss (Switch-style)
    frac = F.one_hot(top_i, E).float().mean(dim=(0, 1, 2))     # (E,)
    mean_p = probs.mean(dim=(0, 1))
    aux = E * (frac * mean_p).sum()
    return y.reshape(B, S, D), aux
