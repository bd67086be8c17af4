"""The stacked-layer LM (dense family): ``make_plan``, ``init_params``,
``forward`` (with or without a decode cache), ``loss_fn`` and the serving
entry points ``init_cache``, ``init_paged_cache``, ``prefill`` and
``decode_step``, as in the JAX ``models/model.py``. The caches are
written in place, where the JAX package returns new ones.

Layers of each pattern position are stacked with a leading (n_groups,)
dim; the JAX ``lax.scan`` over groups is a Python loop over the unbound
layer slices, and ``cfg.remat`` wraps each group in
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .. import tree
from . import blocks as BLK
from . import layers as L


@dataclass(frozen=True)
class Plan:
    pattern: tuple              # block kinds per group
    n_groups: int


def make_plan(cfg) -> Plan:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP.md, port queue: "
            "other families)")
    return Plan(("attn_mlp",), cfg.n_layers)


def init_params(cfg, *, generator, device):
    """Random params with the JAX init's distributions (``dense_init``
    normals, ones for norm scales), drawn from ``generator``. The draws
    are not those of ``jax.random``: parity runs load JAX params with
    ``convert.params_from_numpy`` instead."""
    plan = make_plan(cfg)
    if cfg.pos_emb not in ("rope", "none"):
        raise NotImplementedError(f"pos_emb={cfg.pos_emb!r} is not ported")
    params = {"embed": L.init_embedding(generator, cfg, device=device),
              "ln_f": L.init_norm(cfg.norm, cfg.d_model, device=device),
              "head": L.init_lm_head(generator, cfg, device=device)}
    for i, kind in enumerate(plan.pattern):
        params[f"stack{i}"] = BLK.stacked_init(generator, cfg, kind,
                                               plan.n_groups, device=device)
    return params


def forward(params, cfg, tokens, *, window=None, cache=None,
            cache_pos=None, page_table=None):
    """tokens: (B, S) integer. Returns (logits (B, S, V) float32, cache,
    aux) like the JAX forward; aux is 0 for dense. With ``cache``
    (``init_cache`` or ``init_paged_cache``) the tokens sit at absolute
    positions ``cache_pos`` (an int, default 0) onwards and are written
    into the cache in place (the returned cache is the same tree);
    ``page_table`` ((B, pages_per_slot) on the host) maps a paged cache's
    slots to its pool pages, resolved once for every layer."""
    plan = make_plan(cfg)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    cache_pos = 0 if cache_pos is None else int(cache_pos)
    positions = cache_pos + torch.arange(S, device=tokens.device)
    # unbind each stack once: its backward stacks the per-layer grads in
    # one op (indexing layer by layer would build a full-size zero grad
    # per layer)
    stacks = [_unbind(params[f"stack{i}"], plan.n_groups)
              for i in range(len(plan.pattern))]
    if page_table is not None and cache is not None:
        kp = cache["cache0"]["attn"]["kp"]
        page_table = L.page_index(page_table, cache_pos, S,
                                  page_size=kp.shape[2], device=kp.device)

    def group_body(x, lps, lcs):
        for i, kind in enumerate(plan.pattern):
            x, _ = BLK.apply_block(lps[i], x, cfg, kind, positions=positions,
                                   cache=lcs[i], cache_pos=cache_pos,
                                   window=window, page_table=page_table)
        return x

    for g in range(plan.n_groups):
        lps = [stack[g] for stack in stacks]
        lcs = [None if cache is None
               else tree.map(lambda a: a[g], cache[f"cache{i}"])
               for i in range(len(plan.pattern))]
        if cfg.remat and cache is None and torch.is_grad_enabled():
            x = checkpoint(group_body, x, lps, lcs, use_reentrant=False)
        else:
            x = group_body(x, lps, lcs)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    logits = L.lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return logits, cache, torch.zeros((), device=logits.device)


def _unbind(stack, n):
    """Tree of (n, ...) leaves -> list of n trees of per-layer slices."""
    per_leaf = tree.map(lambda a: torch.unbind(a, 0), stack)
    return [tree.map(lambda t: t[g], per_leaf) for g in range(n)]


def loss_fn(params, cfg, batch):
    logits, _, aux = forward(params, cfg, batch["tokens"])
    ce = L.next_token_loss(logits, batch["tokens"])
    total = ce + cfg.router_aux_coef * aux
    return total, {"loss": ce, "aux": aux}


def init_cache(cfg, batch: int, cache_len: int, dtype, *, device,
               window: int = 0):
    """An empty decode cache: per pattern position, the blocks' caches
    stacked over the layer groups ((n_groups, batch, C, ...) leaves, the
    JAX layout). ``window`` > 0 bounds the ring length C."""
    plan = make_plan(cfg)
    eff = min(cache_len, window) if window else cache_len
    return {f"cache{i}": _stacked(
        lambda: BLK.init_block_cache(cfg, kind, batch, eff, dtype,
                                     device=device), plan.n_groups)
            for i, kind in enumerate(plan.pattern)}


# cache-leaf names that live in the shared page pool (no batch axis after
# the group axis); every other leaf is a per-slot row
PAGED_LEAF_NAMES = ("kp", "vp", "posp")


def init_paged_cache(cfg, batch: int, cache_len: int, dtype, *,
                     page_size: int, n_pages: int, device, window: int = 0):
    """A paged decode cache: the attention rings become ONE shared pool of
    ``n_pages`` pages of ``page_size`` per layer group; the engine maps
    each slot's logical ring (length eff = min(cache_len, window or
    cache_len), a multiple of ``page_size``) onto pool pages through a
    (batch, eff // page_size) page table passed to ``forward``."""
    plan = make_plan(cfg)
    eff = min(cache_len, window) if window else cache_len
    if eff % page_size:
        raise ValueError(
            f"effective cache length {eff} must be a multiple of "
            f"page_size {page_size} (the paged ring must tile exactly "
            "to stay bit-identical to the contiguous ring)")
    return {f"cache{i}": _stacked(
        lambda: BLK.init_paged_block_cache(cfg, kind, batch, eff, dtype,
                                           n_pages=n_pages,
                                           page_size=page_size,
                                           device=device), plan.n_groups)
            for i, kind in enumerate(plan.pattern)}


def _stacked(make_one, n: int):
    """The tree ``make_one()`` with every leaf repeated along a new leading
    (n,) axis."""
    return tree.map(lambda a: a[None].repeat((n,) + (1,) * a.dim()),
                    make_one())


def prefill(params, cfg, tokens, *, window: int = 0, cache_len: int = 0):
    """Run the whole prompt, building the decode cache. Returns (logits,
    cache); ``cache_len`` sizes the cache for the decode that follows
    (default: the prompt length)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max(cache_len, S),
                       getattr(torch, cfg.compute_dtype),
                       device=tokens.device, window=window)
    logits, cache, _ = forward(params, cfg, tokens, cache=cache,
                               cache_pos=0, window=window or None)
    return logits, cache


def decode_step(params, cfg, cache, tokens, pos, *, window: int = 0,
                page_table=None):
    """One decode step. tokens: (B, 1); pos: the absolute position (an
    int). Returns (logits, cache), the cache written in place."""
    logits, cache, _ = forward(params, cfg, tokens, cache=cache,
                               cache_pos=pos, window=window or None,
                               page_table=page_table)
    return logits, cache
