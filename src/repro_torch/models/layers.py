"""Dense transformer building blocks (the dense subset of the JAX
``models/layers.py``), in PyTorch.

Init functions take an explicit ``torch.Generator`` and ``device`` and
return plain dicts of tensors with the JAX tree's keys. Apply functions
keep the JAX layouts at their interfaces: activations (B, S, D), heads
(B, S, H, hd), weights (D, H, hd) / (H, hd, D).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops

NEG_INF = -1e30


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


def ones_init(shape, *, device, lead=()):
    return torch.ones(tuple(lead) + tuple(shape), device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, *, device, lead=()):
    if kind != "rmsnorm":
        return {"scale": ones_init((dim,), device=device, lead=lead),
                "bias": torch.zeros(tuple(lead) + (dim,), device=device)}
    return {"scale": ones_init((dim,), device=device, lead=lead)}


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


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


# ---------------------------------------------------------------------------
# attention (direct, and chunked online-softmax)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """(Sq, Sk) additive float32 bias: 0 where attended, -1e30 masked."""
    kp = k_pos[None, :]
    qp = q_pos[:, None]
    ok = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window and window > 0:
        ok &= kp > qp - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(q, k, v, *, causal=True, window=0, q_offset=0, chunk=1024,
              softcap: float = 0.0, scale: float | None = None):
    """GQA attention. q: (B,Sq,H,dh); k: (B,Sk,G,dh); v: (B,Sk,G,dv).

    A direct path for short kv (the (B,G,rep,Sq,Sk) scores in one
    tensor) and a chunked online-softmax loop for long kv, on the JAX
    package's threshold, so both packages take the same path."""
    B, Sq, H, dh = q.shape
    _, Sk, G, _ = k.shape
    dv = v.shape[-1]
    rep = H // G
    scale = dh ** -0.5 if scale is None else scale
    qh = (q * scale).reshape(B, Sq, G, rep, dh)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    kv_pos = torch.arange(Sk, device=dev)

    if Sk <= max(2 * chunk, 2048) or Sq <= 8:
        s = torch.einsum("bqgrd,bkgd->bgrqk", qh, k).float()
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = s + _mask_bias(q_pos, kv_pos, causal, window)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype), v).float()
        return o.reshape(B, Sq, H, dv).to(q.dtype)

    if Sk % chunk:
        raise ValueError(f"chunked attention needs Sk % chunk == 0, got "
                         f"Sk={Sk}, chunk={chunk}")
    acc = torch.zeros(B, G, rep, Sq, dv, dtype=torch.float32, device=dev)
    m = torch.full((B, G, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros(B, G, rep, Sq, dtype=torch.float32, device=dev)
    for c0 in range(0, Sk, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qh, kc).float()
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = s + _mask_bias(q_pos, kv_pos[c0:c0 + chunk], causal, window)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(vc.dtype), vc).float()
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.movedim(3, 1).reshape(B, Sq, H, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (no cache)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg, *, device, lead=()):
    hd = cfg.resolved_head_dim
    D, H, G = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    init = lambda shape: dense_init(gen, shape, cfg.init_scale,
                                    device=device, lead=lead)
    p = {"wq": init((D, H, hd)), "wk": init((D, G, hd)),
         "wv": init((D, G, hd)), "wo": init((H, hd, D))}
    if cfg.attn_bias or cfg.qk_norm:
        raise NotImplementedError(
            "attention biases and qk-norm belong to other model families "
            "(ROADMAP.md, port queue: other families)")
    return p


def apply_attention(p, x, cfg, *, positions, window=0, causal=True):
    """Self-attention without a decode cache. Returns (out, None)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dgk->bsgk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", x, p["wv"].to(dt))
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    # the JAX model's dispatch rule, condition for condition (it also needs
    # self-attention without kv_positions, which every call here is)
    if (cfg.use_pallas and cfg.resolved_head_dim % 128 == 0
            and q.shape[1] % 128 == 0):
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = attention(q, k, v, causal=causal, window=window,
                        chunk=cfg.attn_chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), None


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
        raise NotImplementedError(
            "MLP biases belong to other model families (ROADMAP.md, port "
            "queue: other families)")
    return p


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(p, x, cfg):
    dt = x.dtype
    h = x @ p["w_up"].to(dt)
    if "w_gate" in p:
        h = _act(x @ p["w_gate"].to(dt), cfg.act) * h
    else:
        h = _act(h, cfg.act)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg, *, device):
    return {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), 1.0,
                                device=device)}


def embed(p, tokens, cfg):
    return p["table"][tokens].to(getattr(torch, cfg.compute_dtype))


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
    logits = (x @ w).float()
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
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, tgt[..., None].long())[..., 0]
    return (lse - picked).mean()
