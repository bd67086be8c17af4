"""Residual blocks: the ``attn_mlp`` kind of the JAX ``models/blocks.py``
(pre-norm self-attention + gated MLP, the paper's dense transformer)."""
from __future__ import annotations

from . import layers as L


def init_block(gen, cfg, kind: str, *, device, lead=()):
    if kind != "attn_mlp" or cfg.n_experts:
        raise NotImplementedError(
            f"block kind {kind!r} (n_experts={cfg.n_experts}) belongs to "
            "another model family (ROADMAP.md, port queue: other families)")
    return {"ln1": L.init_norm(cfg.norm, cfg.d_model, device=device,
                               lead=lead),
            "attn": L.init_attention(gen, cfg, device=device, lead=lead),
            "ln2": L.init_norm(cfg.norm, cfg.d_model, device=device,
                               lead=lead),
            "mlp": L.init_mlp(gen, cfg, device=device, lead=lead)}


def apply_block(p, x, cfg, kind: str, *, positions, window=None):
    """One residual block. ``window`` overrides cfg.window when not None.
    Returns x (no decode cache, no auxiliary loss in this kind)."""
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r} is not ported")
    win = cfg.window if window is None else window
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    a, _ = L.apply_attention(p["attn"], h, cfg, positions=positions,
                             window=win, causal=True)
    if cfg.parallel_block:
        return x + a + L.apply_mlp(p["mlp"], h, cfg)
    x = x + a
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], h2, cfg)


def stacked_init(gen, cfg, kind: str, count: int, *, device):
    """``count`` layers of one kind, each leaf with a leading (count,)
    dim (the JAX ``stacked_init`` layout)."""
    return init_block(gen, cfg, kind, device=device, lead=(count,))
