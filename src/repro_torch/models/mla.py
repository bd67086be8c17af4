"""Multi-head Latent Attention (DeepSeek-V2), as the JAX ``models/mla.py``.

Keys and values are compressed into a rank-``kv_lora_rank`` latent c_kv
plus a small decoupled-RoPE key shared across heads; only (c_kv, k_rope)
is cached. Training and prefill without a cache up-project the latents
to per-head K/V; with a cache the scores are computed in latent space
(the absorbed form: q_eff = q_nope · W_uk), through the generic
``attention`` with a single latent "head".
"""
from __future__ import annotations

import torch

from .layers import (_count, _ring_write, apply_norm, apply_rope, attention,
                     dense_init, ones_init)


MLA_AXES = {"wq": ("embed", "heads", None), "w_dkv": ("embed", None),
            "w_kr": ("embed", None), "ckv_norm": (None,),
            "w_uk": (None, "heads", None), "w_uv": (None, "heads", None),
            "wo": ("heads", None, "embed")}


def init_mla(gen, cfg, *, device, lead=()):
    D, H = cfg.d_model, cfg.n_heads
    dh = cfg.resolved_head_dim          # nope dims per head
    dv = cfg.resolved_v_head_dim
    dr = cfg.rope_head_dim
    r = cfg.kv_lora_rank
    init = lambda shape: dense_init(gen, shape, cfg.init_scale,
                                    device=device, lead=lead)
    return {"wq": init((D, H, dh + dr)), "w_dkv": init((D, r)),
            "w_kr": init((D, dr)),
            "ckv_norm": ones_init((r,), device=device, lead=lead),
            "w_uk": init((r, H, dh)), "w_uv": init((r, H, dv)),
            "wo": init((H, dv, D))}


def _project_qkv_latent(p, x, cfg, positions):
    dt = x.dtype
    dh = cfg.resolved_head_dim
    _count(3)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ p["w_dkv"].to(dt)
    c_kv = apply_norm({"scale": p["ckv_norm"]}, c_kv, "rmsnorm")
    k_rope = x @ p["w_kr"].to(dt)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def apply_mla(p, x, cfg, *, positions, cache=None, cache_pos=None):
    """Returns (out, cache). cache = {"ckv": (B, C, r), "kr": (B, C, dr),
    "pos": (B, C) int32}, a ring written in place; training or a prefill
    without a cache when ``cache`` is None."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    dr = cfg.rope_head_dim
    scale = (dh + dr) ** -0.5
    q_nope, q_rope, c_kv, k_rope = _project_qkv_latent(p, x, cfg, positions)

    if cache is None:
        # up-project the latents to per-head K/V (MHA-like)
        _count(3)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"].to(dt))
        v = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"].to(dt))
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], dr)], -1)
        qq = torch.cat([q_nope, q_rope], -1)
        out = attention(qq, k, v, causal=True, window=cfg.window,
                        chunk=cfg.attn_chunk, scale=scale)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), None

    # absorbed scores in latent space; the ring write keeps only the last
    # C of more than C new tokens
    ckv, kr, pos_t = cache["ckv"], cache["kr"], cache["pos"]
    S, C = x.shape[1], ckv.shape[1]
    skip = max(0, S - C)
    start = int(cache_pos) + skip
    n = S - skip
    _ring_write(ckv, c_kv[:, skip:].to(ckv.dtype), start % C)
    _ring_write(kr, k_rope[:, skip:].to(kr.dtype), start % C)
    track = torch.arange(start, start + n, dtype=pos_t.dtype,
                         device=pos_t.device)
    _ring_write(pos_t, track[None].expand(pos_t.shape[0], n), start % C)

    _count(3)
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(dt))
    q_lat = torch.cat([q_eff, q_rope], -1)              # (B,S,H,r+dr)
    k_lat = torch.cat([ckv, kr], -1)[:, :, None]        # (B,C,1,r+dr)
    v_lat = ckv[:, :, None]                             # (B,C,1,r)
    kv_pos = pos_t if S <= 8 else pos_t[0]
    ctx = attention(q_lat, k_lat, v_lat, causal=True, window=cfg.window,
                    q_offset=int(cache_pos), kv_positions=kv_pos,
                    kv_valid=kv_pos >= 0, chunk=cfg.attn_chunk,
                    scale=scale)                        # (B,S,H,r)
    out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(dt))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), cache


def init_mla_cache(cfg, batch: int, cache_len: int, dtype, *, device):
    return {"ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, cache_len, cfg.rope_head_dim),
                              dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}
