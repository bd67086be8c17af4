"""Transformer building blocks (the JAX ``models/layers.py``), in
PyTorch: norms, RoPE and sin-cos positions, GQA self- and cross-attention
with their decode caches, the MLP, the embedding and the LM head.

Init functions take an explicit ``torch.Generator`` and ``device`` and
return plain dicts of tensors with the JAX tree's keys. Apply functions
keep the JAX layouts at their interfaces: activations (B, S, D), heads
(B, S, H, hd), weights (D, H, hd) / (H, hd, D).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..sharding.spec import constrain, is_dtensor, mark_local

NEG_INF = -1e30

# Forward matmuls this process has issued through this module: each weight
# product (the q, k, v and output projections, the MLP's, the LM head)
# and each attention product (scores and values, per kv chunk; a flash
# call counts as its two), recomputed forwards included. A host-side int,
# bumped where the product is issued: it never waits for the card.
# ``core.pod_collectives.OverlapProbe`` reads it as its ``dots_between``.
matmuls = 0


def _count(n: int = 1):
    global matmuls
    matmuls += n


# ---------------------------------------------------------------------------
# products accumulated in float32
# ---------------------------------------------------------------------------

def f32_product(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` accumulated and returned in float32, as
    the JAX einsum with ``preferred_element_type=jnp.float32`` computes it:
    on float32 operands the plain einsum; on bf16 operands the einsum of
    their float32 values (a product of two bf16 values is exact in float32,
    so only the order of the sums differs from JAX's), never a bf16 result
    widened afterwards. Where no gradient is taken, bf16 operands on the
    card (or on meta tensors, which count the card's work) go through
    cuBLAS's bf16 GEMM that writes float32 instead (``_gemm_f32``)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.einsum(eq, a, b).float()
    if eq in _AS_GEMM and _gemm_f32_ok(a, b):
        out = _AS_GEMM[eq](a, b)
        if out is not None:
            return out
    return torch.einsum(eq, a.float(), b.float())


def f32_matmul(x, w):
    """``x @ w`` (w 2-D) accumulated and returned in float32, as
    ``f32_product``."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return (x @ w).float()
    if _gemm_f32_ok(x, w):
        out = _rows_gemm(x, w)
        if out is not None:
            return out
    return x.float() @ w.float()


# whether this build's ``torch.mm``/``torch.bmm`` take ``out_dtype`` (bf16
# operands, float32 result; forward only: the op has no backward)
_OUT_DTYPE = [True]


def _gemm_f32_ok(a, b) -> bool:
    return (_OUT_DTYPE[0] and a.dtype == b.dtype == torch.bfloat16
            and a.device.type in ("cuda", "meta") and not is_dtensor(a)
            and not is_dtensor(b) and not (torch.is_grad_enabled() and (
                a.requires_grad or b.requires_grad)))


def _gemm_f32(a, b):
    """``a @ b`` of 2-D or 3-D (batched) bf16 operands, float32 out, or
    None where this build has no such GEMM."""
    try:
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        _OUT_DTYPE[0] = False
        return None


def _scores_gemm(a, b):
    """"bqgrd,bkgd->bgrqk" as (B·G) GEMMs."""
    B, Sq, G, R, D = a.shape
    Sk = b.shape[1]
    out = _gemm_f32(a.permute(0, 2, 3, 1, 4).reshape(B * G, R * Sq, D),
                    b.permute(0, 2, 3, 1).reshape(B * G, D, Sk))
    return None if out is None else out.reshape(B, G, R, Sq, Sk)


def _pv_gemm(a, b):
    """"bgrqk,bkgd->bgrqd" as (B·G) GEMMs."""
    B, G, R, Sq, Sk = a.shape
    D = b.shape[-1]
    out = _gemm_f32(a.reshape(B * G, R * Sq, Sk),
                    b.permute(0, 2, 1, 3).reshape(B * G, Sk, D))
    return None if out is None else out.reshape(B, G, R, Sq, D)


def _ssd_gemm(a, b):
    """"bcin,bcjn->bcij" as (B·C) GEMMs."""
    B, C, I, N = a.shape
    out = _gemm_f32(a.reshape(B * C, I, N),
                    b.transpose(2, 3).reshape(B * C, N, b.shape[2]))
    return None if out is None else out.reshape(B, C, I, b.shape[2])


def _rows_gemm(a, b):
    """"...d,de->...e" as one GEMM."""
    out = _gemm_f32(a.reshape(-1, a.shape[-1]), b)
    return None if out is None else out.reshape(*a.shape[:-1], b.shape[-1])


def _latent_scores_gemm(a, b):
    """"bshd,bcd->bhsc" as B GEMMs."""
    B, S, H, D = a.shape
    out = _gemm_f32(a.transpose(1, 2).reshape(B, H * S, D),
                    b.transpose(1, 2))
    return None if out is None else out.reshape(B, H, S, b.shape[1])


def _latent_pv_gemm(a, b):
    """"bhsc,bcr->bshr" as B GEMMs."""
    B, H, S, C = a.shape
    out = _gemm_f32(a.reshape(B, H * S, C), b)
    return None if out is None else \
        out.reshape(B, H, S, b.shape[-1]).transpose(1, 2)


def _pv_out_gemm(a, b):
    """"bgrqk,bkgd->bqgrd" as (B·G) GEMMs."""
    out = _pv_gemm(a, b)
    return None if out is None else out.permute(0, 3, 1, 2, 4)


_AS_GEMM = {
    "bqgrd,bkgd->bgrqk": _scores_gemm,
    "bgrqk,bkgd->bgrqd": _pv_gemm,
    "bgrqk,bkgd->bqgrd": _pv_out_gemm,
    "bcin,bcjn->bcij": _ssd_gemm,
    "gtd,de->gte": _rows_gemm,
    "bshd,bcd->bhsc": _latent_scores_gemm,
    "bhsc,bcr->bshr": _latent_pv_gemm,
}


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen, shape, scale=0.02, *, device, lead=()):
    """Normal init with the JAX ``dense_init`` std, min(scale,
    1/sqrt(fan_in)); ``lead`` prepends stacked-layer dims that do not
    count towards the fan-in."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = min(scale, (1.0 / max(fan_in, 1)) ** 0.5)
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                    device=device, dtype=torch.float32)
    return w.mul_(std)


# Each leaf's logical axes (``sharding/spec.py``), one name or None per dim
# of the unstacked leaf: the axes the JAX init boxes the same leaf with.
NORM_AXES = {"scale": (None,), "bias": (None,)}
ATTENTION_AXES = {
    "wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed"),
    "bq": ("heads", None), "bk": ("kv_heads", None),
    "bv": ("kv_heads", None), "bo": (None,),
    "q_norm": (None,), "k_norm": (None,)}
MLP_AXES = {"w_up": ("embed", "ff"), "w_gate": ("embed", "ff"),
            "w_down": ("ff", "embed"), "b_up": ("ff",), "b_down": (None,)}
EMBED_AXES = {"table": ("vocab", "embed")}
HEAD_AXES = {"w": ("embed", "vocab")}
POS_TABLE_AXES = (None, "embed")


def ones_init(shape, *, device, lead=()):
    return torch.ones(tuple(lead) + tuple(shape), device=device)


def zeros_init(shape, *, device, lead=()):
    return torch.zeros(tuple(lead) + tuple(shape), device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, *, device, lead=()):
    if kind != "rmsnorm":
        return {"scale": ones_init((dim,), device=device, lead=lead),
                "bias": zeros_init((dim,), device=device, lead=lead)}
    return {"scale": ones_init((dim,), device=device, lead=lead)}


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        mu = _mean_last(xf)
        var = _mean_last((xf - mu).square())
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def _mean_last(t):
    """``t.mean(-1, keepdim=True)``; of an island's DTensor whose last dim
    is sharded, the sum over it divided by its size and reduced (an
    all-reduce of the partial sums), so that it meets ``t`` as a
    replicated value (DTensor's partial mean would make ``t - mean``
    partial too, and the gradient of its partial average cannot be
    brought back)."""
    if not is_dtensor(t):
        return t.mean(-1, keepdim=True)
    from torch.distributed.tensor import Replicate
    m = t.sum(-1, keepdim=True) / t.shape[-1]
    return m.redistribute(m.device_mesh, [
        Replicate() if p.is_partial() else p for p in m.placements])


def rms_head_norm(scale, x, eps: float = 1e-6):
    """qk-norm: RMSNorm over the head dim of (B, S, H, hd)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, pct: float = 1.0):
    """(inverse frequencies (rot/2,) float32 numpy, rot). Computed in
    numpy float32 exactly as the JAX package does."""
    rot = int(head_dim * pct) // 2 * 2
    exps = np.arange(0, rot, 2, dtype=np.float32) / np.float32(rot)
    inv = np.float32(1.0) / (np.float32(theta) ** exps)
    return inv.astype(np.float32), rot


@functools.lru_cache(maxsize=32)
def _inv_freqs_on(device, head_dim: int, theta: float, pct: float):
    """``rope_freqs`` as a device tensor, copied once per device and shape:
    a copy from the host at every call would wait for the device's queue
    to drain, twice per layer. The cached tensor is never written."""
    inv, rot = rope_freqs(head_dim, theta, pct)
    return torch.from_numpy(inv).to(device), rot


def apply_rope(x, positions, theta: float, pct: float = 1.0):
    """x: (B, S, H, hd); positions: (S,) or (B, S) integer tensor."""
    inv, rot = _inv_freqs_on(x.device, x.shape[-1], float(theta),
                             float(pct))
    if rot == 0:
        return x
    if positions.dim() == 1:
        ang = positions[:, None].float() * inv[None]             # (S, r/2)
        ang = ang[None, :, None, :]                               # (1,S,1,r/2)
    else:
        ang = positions[..., None].float() * inv                 # (B,S,r/2)
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], -1).reshape(xr.shape)
    return torch.cat([out, xp], -1).to(x.dtype)


def sincos_positions(seq_len: int, dim: int, dtype=torch.float32, *,
                     device):
    """(seq_len, dim) sin-cos position table, computed in float64 numpy
    as the JAX package does, then cast to ``dtype``."""
    pos = np.arange(seq_len)[:, None]
    i = np.arange(dim // 2)[None]
    ang = pos / (10_000 ** (2 * i / dim))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# attention (direct, and chunked online-softmax)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: int, kv_valid=None):
    """Additive float32 bias, 0 where attended and -1e30 where masked:
    (Sq, Sk) for shared key positions k_pos (Sk,), (B, Sq, Sk) for
    per-slot position tracks k_pos (B, Sk) (continuous batching);
    ``kv_valid``, when given, has k_pos's shape. A cache's position track
    on an island mesh is replicated there: its full value is read."""
    if is_dtensor(k_pos):
        k_pos = k_pos.full_tensor()
    if is_dtensor(kv_valid):
        kv_valid = kv_valid.full_tensor()
    kp = k_pos[..., None, :]                   # (..., 1, Sk)
    qp = q_pos[:, None]                        # (Sq, 1)
    ok = torch.ones(torch.broadcast_shapes(kp.shape, qp.shape),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window and window > 0:
        ok &= kp > qp - window
    if kv_valid is not None:
        ok &= kv_valid[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              kv_positions=None, kv_valid=None, chunk=1024,
              softcap: float = 0.0, scale: float | None = None):
    """GQA attention. q: (B,Sq,H,dh); k: (B,Sk,G,dh); v: (B,Sk,G,dv).

    A direct path for short kv or few queries (the (B,G,rep,Sq,Sk) scores
    in one tensor) and a chunked online-softmax loop for long kv, on the
    JAX package's threshold, so both packages take the same path.
    ``q_offset``: absolute position of q[0] (an int). ``kv_positions``:
    absolute positions of the kv entries, (Sk,) or per-slot (B, Sk)
    (defaults to arange; a ring cache passes its position track);
    ``kv_valid``: bool of the same shape (a partly filled cache). On an
    island mesh it runs on each rank's own blocks (``on_local_heads``)."""
    B, Sq, H, _ = q.shape
    _, Sk, G, _ = k.shape
    dv = v.shape[-1]
    rep = H // G
    qh, q_pos = _grouped_queries(q, G, scale, q_offset)
    dev = q.device
    if kv_positions is None:
        kv_positions = torch.arange(Sk, device=dev)

    if Sk <= max(2 * chunk, 2048) or Sq <= 8:
        _count(2)
        s = _scores(qh, k, q_pos, kv_positions, causal, window, kv_valid,
                    softcap)
        p = torch.softmax(s, dim=-1)
        o = f32_product("bgrqk,bkgd->bqgrd", p.to(v.dtype), v)
        return o.reshape(B, Sq, H, dv).to(q.dtype)

    # chunked path: shared position track only (per-slot tracks imply
    # Sq <= 8, the direct path above)
    if kv_positions.dim() != 1:
        raise ValueError("chunked attention needs shared kv positions")
    if Sk % chunk:
        raise ValueError(f"chunked attention needs Sk % chunk == 0, got "
                         f"Sk={Sk}, chunk={chunk}")
    acc = torch.zeros(B, G, rep, Sq, dv, dtype=torch.float32, device=dev)
    m = torch.full((B, G, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros(B, G, rep, Sq, dtype=torch.float32, device=dev)
    for c0 in range(0, Sk, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        _count(2)
        s = _scores(qh, kc, q_pos, kv_positions[c0:c0 + chunk], causal,
                    window, None if kv_valid is None
                    else kv_valid[c0:c0 + chunk], softcap)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + f32_product(
            "bgrqk,bkgd->bgrqd", p.to(vc.dtype), vc)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.movedim(3, 1).reshape(B, Sq, H, dv).to(q.dtype)


def _grouped_queries(q, G: int, scale, q_offset):
    """(q scaled and grouped as (B, Sq, G, rep, dh), the queries' absolute
    positions)."""
    B, Sq, H, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    return ((q * scale).reshape(B, Sq, G, H // G, dh),
            q_offset + torch.arange(Sq, device=q.device))


def _scores(qh, k, q_pos, kv_positions, causal, window, kv_valid, softcap):
    """The float32 scores (B, G, rep, Sq, Sk) of the grouped queries ``qh``
    against keys ``k``: soft-capped, plus the mask's bias (a per-slot
    track's (B, Sq, Sk) bias broadcast over the heads)."""
    s = f32_product("bqgrd,bkgd->bgrqk", qh, k)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    bias = _mask_bias(q_pos, kv_positions, causal, window, kv_valid)
    if bias.dim() == 3:
        bias = bias[:, None, None]
    return s + bias


def attention_stats(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_positions=None, kv_valid=None, softcap: float = 0.0,
                    scale: float | None = None):
    """The direct path of ``attention`` without its normalisation, over a
    block of the keys: (acc (B, G, rep, Sq, dv) = Σ p·v, m (B, G, rep, Sq)
    the block's max score, l the block's Σ p), float32, with p = exp(s −
    m). Blocks combine as flash decoding does (``on_local_heads``)."""
    qh, q_pos = _grouped_queries(q, k.shape[2], scale, q_offset)
    _count(2)
    s = _scores(qh, k, q_pos, kv_positions, causal, window, kv_valid,
                softcap)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = f32_product("bgrqk,bkgd->bgrqd", p.to(v.dtype), v)
    return acc, m, p.sum(-1)


# ---------------------------------------------------------------------------
# GQA attention block, with an optional decode cache
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, *, device, lead=()):
    hd = cfg.resolved_head_dim
    D, H, G = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    init = lambda shape: dense_init(gen, shape, cfg.init_scale,
                                    device=device, lead=lead)
    p = {"wq": init((D, H, hd)), "wk": init((D, G, hd)),
         "wv": init((D, G, hd)), "wo": init((H, hd, D))}
    zeros = lambda shape: zeros_init(shape, device=device, lead=lead)
    if cfg.attn_bias:
        p.update(bq=zeros((H, hd)), bk=zeros((G, hd)), bv=zeros((G, hd)),
                 bo=zeros((D,)))
    if cfg.qk_norm:
        p["q_norm"] = ones_init((hd,), device=device, lead=lead)
        p["k_norm"] = ones_init((hd,), device=device, lead=lead)
    return p


def residual_spec(cfg) -> tuple:
    """The residual stream's spec on an island mesh: the batch over
    cfg.act_batch_axes, and d_model over "model" when act_model_shard
    (Megatron-style), or (act_seq_shard) the sequence over "model"
    (Megatron sequence parallelism)."""
    ba = tuple(cfg.act_batch_axes)
    ba = ba if len(ba) > 1 else ba[0]
    if cfg.act_seq_shard:
        return (ba, "model", None)
    return (ba, None, "model" if cfg.act_model_shard else None)


def whole_features(x, cfg):
    """``x`` (B, S, D) with its whole d_model (and sequence) on every rank
    of the "model" axis, the batch on the activations' axes: what a
    projection whose weight is sharded over its output features reads (on
    an island mesh, the all-gather of Megatron's sequence and tensor
    parallelism, which GSPMD places before the JAX model's projections);
    the identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    ba = tuple(cfg.act_batch_axes)
    return constrain(x, (ba if len(ba) > 1 else ba[0], None, None))


def project_cross_kv(p, cfg, kv_x):
    """Cross-attention K/V of the source ``kv_x`` (B, S_src, D), projected
    once (a prefill caches them; a decode step reuses them)."""
    dt = kv_x.dtype
    _count(2)
    kv_x = whole_features(kv_x, cfg)
    k = torch.einsum("bsd,dgk->bsgk", kv_x, p["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", kv_x, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def _on(a: np.ndarray, device) -> torch.Tensor:
    """A host index array on ``device`` without waiting for the card: a
    copy from pinned memory, queued behind the work already issued."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class PageIndex(NamedTuple):
    """A page table resolved on the host for one write of ``S`` tokens at
    ``cache_pos``: the pool rows (page · page_size + offset) the valid
    tokens land in (``dst``), the rows of the flattened (B·S_eff) new
    tokens they come from (``src``), their absolute positions (``pos``),
    and for the dense view each logical page's pool page (``phys``, 0
    where unmapped) and whether it is mapped (``mapped``). Built once per
    forward and shared by every layer: the table and the clock live on
    the host, so nothing here reads the card."""
    dst: torch.Tensor
    src: torch.Tensor
    pos: torch.Tensor
    phys: torch.Tensor
    mapped: torch.Tensor
    skip: int                  # leading new tokens beyond the ring length


def page_index(page_table, cache_pos: int, S: int, *, page_size: int,
               device) -> PageIndex:
    """``PageIndex`` of ``page_table`` ((B, pages_per_slot) int, numpy or
    a CPU tensor; -1 = unmapped) for ``S`` new tokens at ``cache_pos``."""
    table = np.asarray(page_table.cpu() if torch.is_tensor(page_table)
                       else page_table).astype(np.int64)
    B, pps = table.shape
    C = pps * page_size
    skip = max(0, S - C)
    S_eff = S - skip
    abs_pos = int(cache_pos) + skip + np.arange(S_eff, dtype=np.int64)
    ring = abs_pos % C
    page = table[:, ring // page_size]                     # (B, S_eff)
    ok = page >= 0
    dst = (page * page_size + ring % page_size)[ok]
    src = (np.arange(B)[:, None] * S_eff + np.arange(S_eff)[None])[ok]
    pos = np.broadcast_to(abs_pos[None], (B, S_eff))[ok].astype(np.int32)
    mapped = (table >= 0).reshape(-1)
    phys = np.where(mapped, table.reshape(-1), 0)
    return PageIndex(_on(dst, device), _on(src, device), _on(pos, device),
                     _on(phys, device), _on(mapped, device), skip)


def paged_kv_update(cache, page_table, k, v, cache_pos):
    """Write new tokens into a paged K/V pool, in place, and gather the
    dense ring view (the JAX ``paged_kv_update``).

    cache: {"kp": (n_pages, psize, G, hd), "vp": ..., "posp": (n_pages,
    psize) int32} — a pool of fixed-size pages shared by all slots.
    page_table: (B, pages_per_slot), the physical page backing each
    logical page of each slot's ring (-1 = unmapped: writes are dropped,
    reads come back empty), on the host, or its ``PageIndex``. The
    logical ring has length C = pages_per_slot · psize; the token at
    absolute position p lives at logical page (p % C) // psize, offset
    (p % C) % psize — the contiguous ring's layout, so the gathered dense
    view is value-equal to a contiguous cache and attention over it is
    bit-identical. ``cache_pos``: the absolute position (an int) of the
    first new token.

    Returns (cache, k_dense (B,C,G,hd), v_dense, kv_pos (B,C))."""
    kp, vp, posp = cache["kp"], cache["vp"], cache["posp"]
    psize = kp.shape[1]
    idx = page_table if isinstance(page_table, PageIndex) else \
        page_index(page_table, cache_pos, k.shape[1], page_size=psize,
                   device=kp.device)
    B = k.shape[0]
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
    kp.view((-1,) + kp.shape[2:]).index_copy_(
        0, idx.dst, flat(k[:, idx.skip:]).index_select(0, idx.src)
        .to(kp.dtype))
    vp.view((-1,) + vp.shape[2:]).index_copy_(
        0, idx.dst, flat(v[:, idx.skip:]).index_select(0, idx.src)
        .to(vp.dtype))
    posp.view(-1).index_copy_(0, idx.dst, idx.pos)

    def dense(pool, fill):
        got = pool.index_select(0, idx.phys)
        keep = idx.mapped.reshape((-1,) + (1,) * (got.dim() - 1))
        got = torch.where(keep, got, torch.full((), fill, dtype=got.dtype,
                                                device=got.device))
        return got.reshape((B, -1) + tuple(pool.shape[2:]))

    return cache, dense(kp, 0), dense(vp, 0), dense(posp, -1)


def _ring_write(buf, new, p0: int):
    """``new`` (B, S, ...) into the ring rows ``buf`` (B, C, ...) from slot
    ``p0`` on, wrapping at C (S <= C): at most two slices, in place."""
    C, S = buf.shape[1], new.shape[1]
    n1 = min(S, C - p0)
    buf[:, p0:p0 + n1] = new[:, :n1]
    if n1 < S:
        buf[:, :S - n1] = new[:, n1:]


def apply_attention(p, x, cfg, *, positions, cache=None, cache_pos=None,
                    window=0, causal=True, page_table=None, cross_kv=None):
    """Self- or cross-attention with an optional decode cache. Returns
    (out, cache).

    cache: {"k": (B, C, G, hd), "v": ..., "pos": (B, C) int32}, a ring of
    C slots: the token at absolute position p lives in slot p % C, and
    the ``pos`` track holds each slot's absolute position (-1 = empty),
    so masking stays exact after wrap-around; when more than C tokens
    arrive at once only the last C are kept. A paged cache ({"kp", "vp",
    "posp"}, see ``paged_kv_update``) takes ``page_table`` instead. Both
    are written in place. ``cache_pos``: the absolute position (an int) of
    the first incoming token. Decode (at most 8 queries) masks each slot
    by its own position track; prefill shares row 0's. ``cross_kv``: the
    (k, v) of a cross-attention source (``project_cross_kv``): queries
    alone are rotated, nothing is cached and no mask applies but
    ``causal``."""
    dt = x.dtype
    _count(2 if cross_kv is not None else 4)     # the projections
    x = whole_features(x, cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    if cross_kv is not None:
        k, v = (t.to(dt) for t in cross_kv)
    else:
        k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(dt))
        v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(dt))
        if "bk" in p:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q)
        k = rms_head_norm(p["k_norm"], k)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        if cross_kv is None:
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    if cache is not None and cross_kv is None:
        if "kp" in cache:
            if page_table is None:
                raise ValueError("paged attention cache needs a page_table")
            cache, ck, cv, kv_pos = paged_kv_update(cache, page_table, k, v,
                                                    cache_pos)
        else:
            ck, cv, kv_pos = cache["k"], cache["v"], cache["pos"]
            C, S_new = ck.shape[1], k.shape[1]
            skip = max(0, S_new - C)
            start = int(cache_pos) + skip
            n = S_new - skip
            _ring_write(ck, k[:, skip:].to(ck.dtype), start % C)
            _ring_write(cv, v[:, skip:].to(cv.dtype), start % C)
            track = torch.arange(start, start + n, dtype=kv_pos.dtype,
                                 device=kv_pos.device)
            _ring_write(kv_pos, track[None].expand(kv_pos.shape[0], n),
                        start % C)
        kv_pos1 = kv_pos if q.shape[1] <= 8 else kv_pos[0]
        opts = dict(causal=causal, window=window, q_offset=int(cache_pos))
        out = on_local_heads(
            lambda ql, kl, vl, pos: attention(
                ql, kl, vl, kv_positions=pos, kv_valid=pos >= 0,
                chunk=cfg.attn_chunk, **opts),
            q, ck, cv, cfg, kv_pos=kv_pos1,
            kv_axis=cfg.decode_kv_shard or None,
            stats=lambda ql, kl, vl, pos: attention_stats(
                ql, kl, vl, kv_positions=pos, kv_valid=pos >= 0, **opts))
    # the JAX model's dispatch rule, condition for condition (with a cache
    # or a cross-attention source, JAX never takes the flash branch)
    elif (cfg.use_pallas and cross_kv is None
            and cfg.resolved_head_dim % 128 == 0 and q.shape[1] % 128 == 0):
        _count(2)
        out = on_local_heads(lambda ql, kl, vl, _: kops.flash_attention(
            ql, kl, vl, causal=causal, window=window), q, k, v, cfg)
    else:
        out = on_local_heads(lambda ql, kl, vl, _: attention(
            ql, kl, vl, causal=causal, window=window, chunk=cfg.attn_chunk),
            q, k, v, cfg)
    o = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    if "bo" in p:
        o = o + p["bo"].to(dt)
    return o, cache


def on_local_heads(fn, q, k, v, cfg, *, kv_pos=None, kv_axis=None,
                   stats=None):
    """``fn(q, k, v, kv_pos)``: attention of (B, Sq, H, d) queries over
    (B, Sk, G, d) keys and values (``kv_pos``: their position track, (B,
    Sk) or (Sk,), or None), run on each rank's own batch rows and heads
    where q is an island's DTensor (attention is independent over both,
    so no rank reads another's: what GSPMD makes of the JAX model's
    attention), and as it is on plain tensors. q is laid out with its
    heads on "model" (where they divide it) and the batch on the
    activations' axes, and the output keeps q's layout: the heads are
    never gathered. k and v follow q's heads where both head counts
    divide the axis; otherwise each rank takes the kv heads its query
    heads read from a copy replicated over "model".

    ``kv_axis`` (a cache's ``decode_kv_shard``): the keys' sequence dim
    stays sharded on that mesh axis, and ``stats(q, k, v, kv_pos)`` (the
    direct path's unnormalised ``attention_stats``) runs on each block of
    it; the blocks' softmax maxima and sums, and their weighted values,
    are reduced over the axis (flash decoding: small reductions instead of
    a gather of the cache, as JAX's constraint on the scores' kv dim
    makes GSPMD do). The local work is counted for every block it stands
    for (``spec.mark_local``)."""
    if not is_dtensor(q):
        return fn(q, k, v, kv_pos)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    names = list(mesh.mesh_dim_names)
    kv_ax = kv_axis if (kv_axis in names and stats is not None
                        and k.shape[1] % mesh.size(names.index(kv_axis))
                        == 0) else None
    # the batch lies where the keys' rows lie: on the activations' axes,
    # or, for a decode over a cache laid out by ``cache_pspec``, on "data"
    # alone where the activations' batch takes "model" too (``pure_dp``):
    # the queries, one token a row, go to the cache's layout, never the
    # cache to theirs. An axis that holds the batch holds no heads.
    ba = tuple(names[i] for i, pl in enumerate(k.placements)
               if pl.is_shard(0) and names[i] != kv_ax) \
        if is_dtensor(k) else tuple(a for a in cfg.act_batch_axes
                                    if a != kv_ax)
    n = mesh.size(names.index("model")) if "model" in names else 1
    H, G = q.shape[2], k.shape[2]
    heads = "model" if (H % n == 0 and kv_ax != "model"
                        and "model" not in ba) else None
    split_kv = heads is not None and G % n == 0
    if kv_ax is not None and not split_kv:
        heads = None          # a block's stats keep q's heads whole
    ba = ba if len(ba) > 1 else (ba[0] if ba else None)
    q = constrain(q, (ba, None, heads, None))
    k, v = (constrain(t, (ba, kv_ax, heads if split_kv else None, None))
            for t in (k, v))
    # a block read by ranks that each use a different part of it (q over
    # the kv blocks, k and v over the query heads) has a gradient partial
    # over their axis
    kv_i = names.index(kv_ax) if kv_ax is not None else None
    m_i = names.index("model") if "model" in names else None
    ql = _local_partial(q, [kv_i] if kv_i is not None else [])
    kl, vl = (_local_partial(t, [m_i] if heads is not None and not split_kv
                             else []) for t in (k, v))
    ql, kl, vl = mark_local((q, k), ql, kl, vl)
    pos = kv_pos
    if is_dtensor(pos):
        pos = constrain(pos, (ba, kv_ax) if pos.dim() == 2 else (kv_ax,))
        pos = pos.to_local()
    if heads is not None and not split_kv:
        # this rank's query heads [h0, h0 + Hl) read kv heads h // rep
        rep, Hl = H // G, H // n
        h0 = mesh.get_local_rank(names.index("model")) * Hl
        lo, hi = h0 // rep, (h0 + Hl - 1) // rep + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        if not (Hl % rep == 0 or rep % Hl == 0):
            # neither whole groups nor one group: a kv head per query head
            idx = torch.arange(h0, h0 + Hl, device=kl.device) // rep - lo
            kl, vl = kl[:, :, idx], vl[:, :, idx]
    if kv_ax is None:
        return DTensor.from_local(fn(ql, kl, vl, pos), mesh, q.placements,
                                  run_check=False)
    # flash decoding over the kv blocks of ``kv_ax``
    acc, m, l = stats(ql, kl, vl, pos)
    batch = set(ba) if isinstance(ba, tuple) else {ba}

    def over_kv(x, op):
        pl = [Partial(op) if a == kv_ax else Shard(0) if a in batch
              else Shard(1) if (a == "model" and heads) else Replicate()
              for a in names]
        done = [Replicate() if a == kv_ax else p for a, p in zip(names, pl)]
        return DTensor.from_local(x, mesh, pl, run_check=False) \
            .redistribute(mesh, done).to_local()

    big = over_kv(m, "max")
    scale = torch.exp(m - big)
    o = over_kv(acc * scale[..., None], "sum") / torch.clamp(
        over_kv(l * scale, "sum"), min=1e-30)[..., None]
    B_l, Sq = ql.shape[0], ql.shape[1]
    o = o.movedim(3, 1).reshape(B_l, Sq, ql.shape[2], o.shape[-1])
    return DTensor.from_local(o.to(ql.dtype), mesh, q.placements,
                              run_check=False)


def init_attn_cache(cfg, batch: int, cache_len: int, dtype, *, device):
    """A contiguous ring cache of ``cache_len`` slots per row, empty."""
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": torch.zeros((batch, cache_len, G, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cache_len, G, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}


def init_paged_attn_cache(cfg, n_pages: int, page_size: int, dtype, *,
                          device):
    """One shared pool of ``n_pages`` pages replacing the per-slot ring
    rows: slots map logical ring pages to pool pages through the engine's
    page table, so short requests only occupy the pages they touch."""
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"kp": torch.zeros((n_pages, page_size, G, hd), dtype=dtype,
                              device=device),
            "vp": torch.zeros((n_pages, page_size, G, hd), dtype=dtype,
                              device=device),
            "posp": torch.full((n_pages, page_size), -1, dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, *, device, lead=()):
    D, Fd = cfg.d_model, cfg.d_ff
    init = lambda shape: dense_init(gen, shape, cfg.init_scale,
                                    device=device, lead=lead)
    p = {"w_up": init((D, Fd)), "w_down": init((Fd, D))}
    if cfg.mlp_gated:
        p["w_gate"] = init((D, Fd))
    if cfg.mlp_bias:
        p["b_up"] = zeros_init((Fd,), device=device, lead=lead)
        p["b_down"] = zeros_init((D,), device=device, lead=lead)
    return p


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg):
    dt = x.dtype
    _count(2 + ("w_gate" in p))
    x = whole_features(x, cfg)
    h = x @ p["w_up"].to(dt)
    if "b_up" in p:
        h = h + p["b_up"].to(dt)
    if "w_gate" in p:
        h = _act(x @ p["w_gate"].to(dt), cfg.act) * h
    else:
        h = _act(h, cfg.act)
    o = h @ p["w_down"].to(dt)
    if "b_down" in p:
        o = o + p["b_down"].to(dt)
    return o


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg, *, device):
    return {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), 1.0,
                                device=device)}


def embed(p, tokens, cfg):
    dt = getattr(torch, cfg.compute_dtype)
    if is_dtensor(p["table"]):
        return _embed_on_mesh(p["table"], tokens, cfg).to(dt)
    return p["table"][tokens].to(dt)


def _local_partial(t, axes):
    """``t.to_local()``, its gradient declared partial over the mesh
    ``axes`` (the ranks of an axis where ``t`` is replicated each use a
    different part of it, so their gradients are summed)."""
    from torch.distributed.tensor import Partial
    if not axes:
        return t.to_local()
    return t.to_local(grad_placements=[
        Partial() if i in axes else p for i, p in enumerate(t.placements)])


def _embed_on_mesh(table, tokens, cfg):
    """The embedding gather of a table on an island mesh, from each rank's
    block (Megatron's vocab-parallel embedding, as GSPMD partitions the
    JAX gather): the table's other shards (FSDP's feature columns) are
    gathered, its vocab rows stay split where they are, each rank looks
    up the tokens of its own batch rows that fall in its block of the
    vocab (0 for the others), and the blocks sum over the vocab's axis (a
    ``Partial`` result, reduced where it is read: the residual stream's
    ``constrain``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    axis = next((i for i, p in enumerate(table.placements)
                 if p.is_shard(0)), None)
    table = table.redistribute(mesh, [
        p if i == axis else Replicate() for i, p in enumerate(
            table.placements)])
    ba = tuple(a for a in cfg.act_batch_axes
               if axis is None or a != mesh.mesh_dim_names[axis])
    ba = ba if len(ba) > 1 else (ba[0] if ba else None)
    tokens = tokens if is_dtensor(tokens) else DTensor.from_local(
        tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tokens = constrain(tokens, (ba, None))
    # each rank reads the table for its own rows: its gradient is partial
    # over the axes the rows are split on
    rows = [i for i, p in enumerate(tokens.placements) if p.is_shard()]
    ids, block = mark_local(tokens, tokens.to_local(),
                            _local_partial(table, rows))
    vl = block.shape[0]
    idx = ids.long() - (0 if axis is None
                        else mesh.get_local_rank(axis) * vl)
    out = block[idx.clamp(0, vl - 1)]
    if axis is not None:
        ok = (idx >= 0) & (idx < vl)
        out = torch.where(ok[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
    return DTensor.from_local(
        out, mesh, [Partial() if i == axis else p
                    for i, p in enumerate(tokens.placements)],
        run_check=False)


def init_lm_head(gen, cfg, *, device):
    if cfg.tie_embeddings:
        return {}
    return {"w": dense_init(gen, (cfg.d_model, cfg.vocab_size),
                            cfg.init_scale, device=device)}


def lm_logits(head_p, emb_p, x, cfg):
    if cfg.tie_embeddings:
        w = emb_p["table"].to(x.dtype).T
    else:
        w = head_p["w"].to(x.dtype)
    _count()
    x = whole_features(x, cfg)
    if is_dtensor(w) and x.shape[1] > 1:
        # over a sequence, the weight's shards of d_model (FSDP's) are
        # gathered, the vocab kept where it lies: what DTensor itself does
        # at full-size train and prefill shapes, where the tokens'
        # activations outweigh the weight's block. For a few tokens it
        # would move the activations instead, and the dry run counts a
        # per-token loop's long pass at a few tokens (``_extrapolated``).
        from torch.distributed.tensor import Replicate
        w = w.redistribute(w.device_mesh, [
            Replicate() if q.is_shard(0) else q for q in w.placements])
    logits = f32_matmul(x, w)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def next_token_loss(logits, tokens):
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:], as
    logsumexp(logits) − logits[target]."""
    lg = logits[:, :-1].float()
    tgt = tokens[:, 1:]
    if is_dtensor(lg):
        return _ce_on_mesh(lg, tgt)
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tgt[..., None].long())[..., 0]
    return (lse - picked).mean()


def _ce_on_mesh(lg, tgt):
    """``next_token_loss``'s per-token terms on an island mesh, from each
    rank's block of the logits, as GSPMD partitions the JAX loss: where
    the vocab dim is sharded, the logsumexp reduces each block's max and
    sum of exponentials over the vocab's mesh axis (two (B, S) all-reduces
    instead of a gather of the logits), and each rank picks the targets
    that fall in its block of the vocab (0 for the others), the picks
    summed over that axis. The other mesh axes keep the logits' shards (a
    partial sum is reduced first), the targets laid out to match, and the
    mean is DTensor's over the terms' blocks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh, last = lg.device_mesh, lg.dim() - 1
    axis = next((i for i, p in enumerate(lg.placements) if p.is_shard(last)),
                None)
    keep = [p if (p.is_shard() and i != axis) else Replicate()
            for i, p in enumerate(lg.placements)]
    lg = lg.redistribute(mesh, [lg.placements[i] if i == axis else p
                                for i, p in enumerate(keep)])
    tgt = tgt if is_dtensor(tgt) else DTensor.from_local(
        tgt, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tgt = tgt.redistribute(mesh, keep).to_local().long()
    block, = mark_local(lg, lg.to_local())
    vl = block.shape[-1]

    def over_vocab(x, op):
        """A (B, S) block reduced over the vocab's axis (x itself when the
        vocab is whole on every rank)."""
        if axis is None:
            return x
        return DTensor.from_local(
            x, mesh, [Partial(op) if i == axis else p
                      for i, p in enumerate(keep)],
            run_check=False).redistribute(mesh, keep).to_local()

    m = over_vocab(block.detach().amax(-1), "max")
    lse = m + torch.log(over_vocab(
        torch.exp(block - m[..., None]).sum(-1), "sum"))
    idx = tgt - (0 if axis is None else mesh.get_local_rank(axis) * vl)
    got = torch.gather(block, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    if axis is not None:
        ok = (idx >= 0) & (idx < vl)
        got = torch.where(ok, got, torch.zeros((), dtype=got.dtype,
                                               device=got.device))
    terms = lse - over_vocab(got, "sum")
    return DTensor.from_local(terms, mesh, keep, run_check=False).mean()
