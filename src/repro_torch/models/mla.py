"""Multi-head Latent Attention (DeepSeek-V2), as the JAX ``models/mla.py``.

Keys and values are compressed into a rank-``kv_lora_rank`` latent c_kv
plus a small decoupled-RoPE key shared across heads; only (c_kv, k_rope)
is cached. Training and prefill without a cache up-project the latents
to per-head K/V; with a cache the scores are computed in latent space
(the absorbed form: q_eff = q_nope · W_uk), through the generic
``attention`` with a single latent "head".

On an island's DTensors the heads of ``wq``, ``w_uk``, ``w_uv`` and ``wo``
lie over "model" (``w_dkv`` and ``w_kr`` shard their d_model rows there
instead), the latent c_kv and the RoPE key are whole on every rank of
"model", attention runs on each rank's own heads (``on_local_heads``), and
a decode step reads the latent ring where ``cache_pspec`` lays it, its
features over "model" (``_latent_decode``: partial scores reduced, no
gather of the ring).
"""
from __future__ import annotations

import torch

from ..sharding.spec import constrain, from_block, is_dtensor, mark_local
from .layers import (_count, _local_partial, _ring_write, apply_norm,
                     apply_rope, attention, attention_stats, dense_init,
                     on_local_heads, ones_init, whole_features)


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
    """(q_nope, q_rope, c_kv, k_rope). On an island mesh the projections
    read whole features, the queries keep their heads over "model", and
    the latent and the shared RoPE key are whole on every rank of "model"
    (their projections' partial sums reduced before the latent's norm)."""
    dt = x.dtype
    dh = cfg.resolved_head_dim
    _count(3)
    x = whole_features(x, cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = whole_features(x @ p["w_dkv"].to(dt), cfg)
    c_kv = apply_norm({"scale": p["ckv_norm"]}, c_kv, "rmsnorm")
    k_rope = whole_features(x @ p["w_kr"].to(dt), cfg)
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
        k = _with_rope_key(k_nope, k_rope, cfg)
        qq = torch.cat([q_nope, q_rope], -1)
        out = on_local_heads(lambda ql, kl, vl, _: attention(
            ql, kl, vl, causal=True, window=cfg.window,
            chunk=cfg.attn_chunk, scale=scale), qq, k, v, cfg)
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
    if _on_latent_shards(q_eff, ckv, kr, cfg):
        ctx = _latent_decode(q_eff, q_rope, ckv, kr, pos_t, cfg, scale,
                             int(cache_pos))
        out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(dt))
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), cache
    q_lat = torch.cat([q_eff, q_rope], -1)              # (B,S,H,r+dr)
    k_lat = torch.cat([ckv, kr], -1)[:, :, None]        # (B,C,1,r+dr)
    v_lat = ckv[:, :, None]                             # (B,C,1,r)
    kv_pos = pos_t if S <= 8 else pos_t[0]
    opts = dict(causal=True, window=cfg.window, q_offset=int(cache_pos),
                scale=scale)
    ctx = on_local_heads(
        lambda ql, kl, vl, pos: attention(
            ql, kl, vl, kv_positions=pos, kv_valid=pos >= 0,
            chunk=cfg.attn_chunk, **opts),
        q_lat, k_lat, v_lat, cfg, kv_pos=kv_pos,
        kv_axis=cfg.decode_kv_shard or None,
        stats=lambda ql, kl, vl, pos: attention_stats(
            ql, kl, vl, kv_positions=pos, kv_valid=pos >= 0,
            **opts))                                    # (B,S,H,r)
    out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(dt))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt)), cache


def _on_latent_shards(q_eff, ckv, kr, cfg) -> bool:
    """Whether a decode step (at most 8 queries) on an island mesh reads
    the latent ring where ``cache_pspec`` lays it, its features over
    "model" (``_latent_decode``); ``decode_kv_shard`` takes the generic
    path (the ring's sequence over that axis)."""
    if not is_dtensor(q_eff) or q_eff.shape[1] > 8 or cfg.decode_kv_shard:
        return False
    names = list(q_eff.device_mesh.mesh_dim_names)
    if "model" not in names:
        return False
    n = q_eff.device_mesh.size(names.index("model"))
    return n > 1 and ckv.shape[-1] % n == 0 and kr.shape[-1] % n == 0


def _latent_decode(q_eff, q_rope, ckv, kr, pos_t, cfg, scale, q_offset):
    """The absorbed decode's attention (``attention``'s direct path over
    the one latent "head") with the latent ring's features over "model",
    as ``cache_pspec`` lays them: each rank takes the scores' partial sums
    over its own features of c_kv and of the RoPE key (a feature
    contraction may run in any order), the sums are reduced over "model"
    (a (B, H, S, C) all-reduce where a gather of the ring would move the
    ring), and each rank's context keeps its own latent features. Returns
    the (B, S, H, r) context, its latent over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from .layers import _mask_bias, f32_product
    mesh = q_eff.device_mesh
    names = list(mesh.mesh_dim_names)
    ba = tuple(a for a in cfg.act_batch_axes if a != "model")
    ba_spec = (ba if len(ba) > 1 else ba[0]) if ba else None
    qe, qr = (constrain(t, (ba_spec, None, None, "model"))
              for t in (q_eff, q_rope))
    ck, kk = (constrain(t, (ba_spec, None, "model")) for t in (ckv, kr))
    pos = constrain(pos_t, (ba_spec, None))
    batch = [a for a, q in zip(names, ck.placements) if q.is_shard(0)]
    le, lr, lc, lkr = mark_local((qe, ck), qe.to_local(), qr.to_local(),
                                 ck.to_local(), kk.to_local())
    lq, lk = torch.cat([le, lr], -1) * scale, torch.cat([lc, lkr], -1)
    part = f32_product("bshd,bcd->bhsc", lq, lk)        # over own features

    def placed(model):
        return [model if a == "model" else Shard(0) if a in batch
                else Replicate() for a in names]
    s = DTensor.from_local(part, mesh, placed(Partial()), run_check=False) \
        .redistribute(mesh, placed(Replicate())).to_local()
    kv_pos = pos.to_local() if is_dtensor(pos) else pos
    q_pos = q_offset + torch.arange(lq.shape[1], device=lq.device)
    s = s + _mask_bias(q_pos, kv_pos, True, cfg.window,
                       kv_pos >= 0)[:, None]
    p = torch.softmax(s, dim=-1)
    ctx = f32_product("bhsc,bcr->bshr", p.to(lc.dtype), lc).to(q_eff.dtype)
    pl = [Shard(3) if a == "model" else Shard(0) if a in batch
          else Replicate() for a in names]
    return from_block(ctx, mesh, pl,
                      tuple(q_eff.shape[:3]) + (ckv.shape[-1],))


def _with_rope_key(k_nope, k_rope, cfg):
    """Per-head keys (B, S, H, dh + dr): ``k_nope`` (B, S, H, dh) beside the
    RoPE key ``k_rope`` (B, S, dr) that every head shares. On an island
    mesh the heads stay where ``k_nope``'s lie (over "model") and each rank
    widens its whole copy of the shared key to its own heads, the key's
    gradient partial over the heads' axis (no gather of the widened
    key)."""
    dr = k_rope.shape[-1]
    if not is_dtensor(k_nope):
        return torch.cat([k_nope, k_rope[:, :, None, :].expand(
            *k_nope.shape[:3], dr)], -1)
    ba = tuple(cfg.act_batch_axes)
    h_ax = None if "model" in ba else "model"       # pure_dp: rows on it
    ba = ba if len(ba) > 1 else ba[0]
    k_nope = constrain(k_nope, (ba, None, h_ax, None))
    k_rope = constrain(k_rope, (ba, None, None))
    heads = [i for i, q in enumerate(k_nope.placements) if q.is_shard(2)]
    kn, kr = mark_local(k_nope, k_nope.to_local(),
                        _local_partial(k_rope, heads))
    k = torch.cat([kn, kr[:, :, None, :].expand(*kn.shape[:3], dr)], -1)
    return from_block(k, k_nope.device_mesh, k_nope.placements,
                      tuple(k_nope.shape[:3]) + (k.shape[-1],))


def init_mla_cache(cfg, batch: int, cache_len: int, dtype, *, device):
    return {"ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros((batch, cache_len, cfg.rope_head_dim),
                              dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                              device=device)}
