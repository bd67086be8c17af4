"""Residual blocks: the ``attn_mlp`` kind of the JAX ``models/blocks.py``
(pre-norm self-attention + gated MLP, the paper's dense transformer), with
its decode caches (``init_block_cache``, ``init_paged_block_cache``)."""
from __future__ import annotations

from . import layers as L


def _check_kind(cfg, kind: str):
    if kind != "attn_mlp" or cfg.n_experts:
        raise NotImplementedError(
            f"block kind {kind!r} (n_experts={cfg.n_experts}) belongs to "
            "another model family (ROADMAP.md, port queue: other families)")


def init_block(gen, cfg, kind: str, *, device, lead=()):
    _check_kind(cfg, kind)
    return {"ln1": L.init_norm(cfg.norm, cfg.d_model, device=device,
                               lead=lead),
            "attn": L.init_attention(gen, cfg, device=device, lead=lead),
            "ln2": L.init_norm(cfg.norm, cfg.d_model, device=device,
                               lead=lead),
            "mlp": L.init_mlp(gen, cfg, device=device, lead=lead)}


def apply_block(p, x, cfg, kind: str, *, positions, cache=None,
                cache_pos=None, window=None, page_table=None):
    """One residual block. ``window`` overrides cfg.window when not None.
    ``cache`` ({"attn": ...}, see ``init_block_cache``) is written in
    place. Returns (x, cache): the dense kind has no auxiliary loss."""
    _check_kind(cfg, kind)
    win = cfg.window if window is None else window
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    a, _ = L.apply_attention(p["attn"], h, cfg, positions=positions,
                             cache=None if cache is None else cache["attn"],
                             cache_pos=cache_pos, window=win, causal=True,
                             page_table=page_table)
    if cfg.parallel_block:
        return x + a + L.apply_mlp(p["mlp"], h, cfg), cache
    x = x + a
    h2 = L.apply_norm(p["ln2"], x, cfg.norm)
    return x + L.apply_mlp(p["mlp"], h2, cfg), cache


def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype, *,
                     device):
    """An empty decode cache for one block of ``kind``."""
    _check_kind(cfg, kind)
    return {"attn": L.init_attn_cache(cfg, batch, cache_len, dtype,
                                      device=device)}


def init_paged_block_cache(cfg, kind: str, batch: int, cache_len: int,
                           dtype, *, n_pages: int, page_size: int, device):
    """The paged variant of ``init_block_cache``: the attention ring lives
    in one shared page pool (the engine's page table maps each slot's
    logical ring pages to pool pages)."""
    _check_kind(cfg, kind)
    return {"attn": L.init_paged_attn_cache(cfg, n_pages, page_size, dtype,
                                            device=device)}


def stacked_init(gen, cfg, kind: str, count: int, *, device):
    """``count`` layers of one kind, each leaf with a leading (count,)
    dim (the JAX ``stacked_init`` layout)."""
    return init_block(gen, cfg, kind, device=device, lead=(count,))
