"""The stacked-layer LM of every architecture family: ``make_plan``,
``init_params``, ``forward`` (with or without a decode cache), ``loss_fn``
and the serving entry points ``init_cache``, ``init_paged_cache``,
``prefill`` and ``decode_step``, as in the JAX ``models/model.py``. The
caches are written in place, where the JAX package returns new ones.

A ``Plan`` is the repeating pattern of block kinds. Layers of each
pattern position are stacked with a leading (n_groups,) dim; the JAX
``lax.scan`` over groups is a Python loop over the unbound layer slices,
and ``cfg.remat`` wraps each group in ``torch.utils.checkpoint``
(non-reentrant), the counterpart of ``jax.checkpoint``. The pattern entry
"SHARED" (zamba2) is one tied block, ``params["shared"]``, invoked once a
group (its gradients sum over the invocations), with a cache per
invocation. The encoder-decoder family (whisper) runs an encoder stack
over its ``frames`` input first; it and the VLM family feed their
modality input to the cross-attention blocks, which project it once at
prefill and read the cached K/V at decode.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..sharding.spec import (cache_pspec, constrain, empty_on_mesh,
                             is_dtensor, mesh_shape)
from . import blocks as BLK
from . import layers as L


@dataclass(frozen=True)
class Plan:
    pattern: tuple              # block kinds per group, may hold "SHARED"
    n_groups: int
    shared_kind: str = ""       # kind of the SHARED block (zamba2)
    enc_layers: int = 0         # whisper encoder depth
    cross_src: str = ""         # batch key of the modality input


def make_plan(cfg) -> Plan:
    f = cfg.family
    if f == "dense":
        return Plan(("attn_mlp",), cfg.n_layers)
    if f == "moe":
        return Plan(("mla_moe" if cfg.mla else "attn_mlp",), cfg.n_layers)
    if f == "vlm":
        e = cfg.cross_attn_every
        assert cfg.n_layers % e == 0
        return Plan(("attn_mlp",) * (e - 1) + ("cross_mlp",),
                    cfg.n_layers // e, cross_src="patches")
    if f == "encdec":
        return Plan(("self_cross_mlp",), cfg.n_layers,
                    enc_layers=cfg.n_enc_layers, cross_src="frames")
    if f == "hybrid":
        e = cfg.shared_attn_every
        assert cfg.n_layers % e == 0
        return Plan(("mamba2",) * e + ("SHARED",), cfg.n_layers // e,
                    shared_kind="attn_mlp")
    if f == "ssm":
        if cfg.slstm_every:
            e = cfg.slstm_every
            assert cfg.n_layers % e == 0
            return Plan(("mlstm",) * (e - 1) + ("slstm",),
                        cfg.n_layers // e)
        return Plan(("mamba2",), cfg.n_layers)
    raise ValueError(f)


def _kind(plan: Plan, kind: str) -> str:
    return plan.shared_kind if kind == "SHARED" else kind


def init_params(cfg, *, generator, device):
    """Random params with the JAX init's distributions (``dense_init``
    normals, ones for norm scales, zeros for biases and gates, +3 for the
    xLSTM forget biases), drawn from ``generator``. The draws are not
    those of ``jax.random``: parity runs load JAX params with
    ``convert.params_from_numpy`` instead."""
    plan = make_plan(cfg)
    params = {"embed": L.init_embedding(generator, cfg, device=device),
              "ln_f": L.init_norm(cfg.norm, cfg.d_model, device=device),
              "head": L.init_lm_head(generator, cfg, device=device)}
    if cfg.pos_emb == "learned":
        params["pos_table"] = L.dense_init(
            generator, (min(cfg.max_position, 1 << 16), cfg.d_model),
            cfg.init_scale, device=device)
    for i, kind in enumerate(plan.pattern):
        if kind != "SHARED":
            params[f"stack{i}"] = BLK.stacked_init(
                generator, cfg, kind, plan.n_groups, device=device)
    if plan.shared_kind:
        params["shared"] = BLK.init_block(generator, cfg, plan.shared_kind,
                                          device=device)
    if plan.enc_layers:
        params["encoder"] = BLK.stacked_init(generator, cfg, "enc_attn_mlp",
                                             plan.enc_layers, device=device)
        params["enc_ln_f"] = L.init_norm(cfg.norm, cfg.d_model,
                                         device=device)
    return params


def param_axes(cfg):
    """The logical-axes tree of ``init_params(cfg)``: per leaf a tuple of
    logical axis names (``sharding/spec.py``), None for a dim no rule
    shards, the stacked-layer dim first. These are the axes the JAX init
    boxes each leaf with (its ``unbox`` tree)."""
    plan = make_plan(cfg)
    stacked = lambda table: tree.map(lambda ax: (None,) + ax, table)
    table = {"embed": L.EMBED_AXES, "ln_f": L.NORM_AXES,
             "head": L.HEAD_AXES, "pos_table": L.POS_TABLE_AXES,
             "enc_ln_f": L.NORM_AXES,
             "encoder": stacked(BLK.block_axes("enc_attn_mlp"))}
    for i, kind in enumerate(plan.pattern):
        if kind != "SHARED":
            table[f"stack{i}"] = stacked(BLK.block_axes(kind))
    if plan.shared_kind:
        table["shared"] = BLK.block_axes(plan.shared_kind)
    shapes = init_params(cfg, generator=None, device="meta")
    return tree.map(lambda _, ax: ax, shapes, table)


def _remat(cfg, cache) -> bool:
    return cfg.remat and cache is None and torch.is_grad_enabled()


def _run_encoder(params, cfg, frames):
    """The whisper-style encoder over the frame embeddings (B, T, D), with
    sin-cos positions added."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + L.sincos_positions(x.shape[1], cfg.d_model, x.dtype,
                               device=x.device)[None]
    pos = torch.arange(x.shape[1], device=x.device)

    def body(x, lp):
        return BLK.apply_block(lp, x, cfg, "enc_attn_mlp", positions=pos,
                               window=0)[0]

    for lp in _unbind(params["encoder"], cfg.n_enc_layers):
        x = checkpoint(body, x, lp, use_reentrant=False) \
            if _remat(cfg, None) else body(x, lp)
    return L.apply_norm(params["enc_ln_f"], x, cfg.norm)


def _first_pool(cache):
    """A paged cache's first page pool ("kp"), or None."""
    if isinstance(cache, dict):
        if "kp" in cache:
            return cache["kp"]
        for key in sorted(cache):
            got = _first_pool(cache[key])
            if got is not None:
                return got
    return None


def forward(params, cfg, tokens, *, extra=None, window=None, cache=None,
            cache_pos=None, page_table=None, groups: int = 1):
    """tokens: (B, S) integer. Returns (logits (B, S, V) float32, cache,
    aux) like the JAX forward; aux is the MoE load-balancing loss summed
    over the layers (0 without experts). ``extra``: the batch's other
    inputs (``patches`` of a VLM, ``frames`` of the encoder-decoder),
    projected by the cross-attention blocks. With ``cache``
    (``init_cache`` or ``init_paged_cache``) the tokens sit at absolute
    positions ``cache_pos`` (an int, default 0) onwards and are written
    into the cache in place (the returned cache is the same tree);
    ``page_table`` ((B, pages_per_slot) on the host) maps a paged cache's
    slots to its pool pages, resolved once for every layer."""
    plan = make_plan(cfg)
    dt = getattr(torch, cfg.compute_dtype)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    # the residual stream's layout on an island mesh (``L.residual_spec``);
    # the identity off one
    x = constrain(x, L.residual_spec(cfg))
    cache_pos = 0 if cache_pos is None else int(cache_pos)
    positions = cache_pos + torch.arange(S, device=tokens.device)
    if cfg.pos_emb == "learned":
        tbl = params["pos_table"].to(dt)
        start = min(max(cache_pos, 0), tbl.shape[0] - S)
        x = x + tbl[start:start + S][None]
    elif cfg.pos_emb == "sincos":
        x = x + L.sincos_positions(S, cfg.d_model, dt, device=x.device)[None]

    cross_src = None
    if plan.cross_src and extra is not None and plan.cross_src in extra:
        src = extra[plan.cross_src]
        if plan.enc_layers:
            src = _run_encoder(params, cfg, src)
        cross_src = src.to(dt)
    elif plan.cross_src and cache is None:
        raise ValueError(
            f"{cfg.family} cross-attention needs the batch's "
            f"{plan.cross_src!r} input (train/prefill) or a prefilled "
            "cache (decode)")
    # decode (no extra): the blocks read their cached cross K/V, projected
    # once, at prefill

    # unbind each stack once: its backward stacks the per-layer grads in
    # one op (indexing layer by layer would build a full-size zero grad
    # per layer)
    stacks = [None if kind == "SHARED"
              else _unbind(params[f"stack{i}"], plan.n_groups)
              for i, kind in enumerate(plan.pattern)]
    pool = _first_pool(cache) if page_table is not None else None
    if pool is not None:
        page_table = L.page_index(page_table, cache_pos, S,
                                  page_size=pool.shape[2], device=pool.device)

    def group_body(x, aux, lps, lcs):
        for i, kind in enumerate(plan.pattern):
            p = params["shared"] if kind == "SHARED" else lps[i]
            x, _, a = BLK.apply_block(
                p, x, cfg, _kind(plan, kind), positions=positions,
                cache=lcs[i], cache_pos=cache_pos, kv_x=cross_src,
                groups=groups, window=window, page_table=page_table)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), device=x.device)
    for g in range(plan.n_groups):
        lps = [None if stack is None else stack[g] for stack in stacks]
        lcs = [None if cache is None
               else tree.map_nested(lambda a: a[g], cache[f"cache{i}"])
               for i in range(len(plan.pattern))]
        if _remat(cfg, cache):
            x, aux = checkpoint(group_body, x, aux, lps, lcs,
                                use_reentrant=False)
        else:
            x, aux = group_body(x, aux, lps, lcs)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    logits = L.lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return logits, cache, aux


def _unbind(stack, n):
    """Tree of (n, ...) leaves -> list of n trees of per-layer slices."""
    per_leaf = tree.map(lambda a: torch.unbind(a, 0), stack)
    return [tree.map(lambda t: t[g], per_leaf) for g in range(n)]


def loss_fn(params, cfg, batch, *, groups: int = 1):
    logits, _, aux = forward(params, cfg, batch["tokens"], extra=batch,
                             groups=groups)
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
        lambda: BLK.init_block_cache(cfg, _kind(plan, kind), batch, eff,
                                     dtype, device=device), plan.n_groups)
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
        lambda: BLK.init_paged_block_cache(cfg, _kind(plan, kind), batch,
                                           eff, dtype,
                                           n_pages=n_pages,
                                           page_size=page_size,
                                           device=device), plan.n_groups)
            for i, kind in enumerate(plan.pattern)}


def _cache_fills(cfg):
    """The constant each leaf of ``init_cache``'s tree starts at (0, -1
    for a position track, xLSTM's stabiliser ``M_INIT``), read off one
    block's cache of each kind at one row and one slot."""
    plan = make_plan(cfg)
    return tree.map_nested(lambda t: t.reshape(-1)[0].item(), {
        f"cache{i}": BLK.init_block_cache(cfg, _kind(plan, kind), 1, 1,
                                          torch.float32, device="cpu")
        for i, kind in enumerate(plan.pattern)})


def _stacked(make_one, n: int):
    """The tree ``make_one()`` with every leaf repeated along a new leading
    (n,) axis."""
    return tree.map_nested(
        lambda a: a[None].repeat((n,) + (1,) * a.dim()), make_one())


def prefill(params, cfg, tokens, *, extra=None, window: int = 0,
            cache_len: int = 0, groups: int = 1):
    """Run the whole prompt (and ``extra``, the modality input of the
    cross-attention families), building the decode cache. Returns (logits,
    cache); ``cache_len`` sizes the cache for the decode that follows
    (default: the prompt length); ``groups``: the MoE token grouping."""
    B, S = tokens.shape
    make = lambda device: init_cache(cfg, B, max(cache_len, S),
                                     getattr(torch, cfg.compute_dtype),
                                     device=device, window=window)
    if is_dtensor(tokens):
        # on an island mesh each rank makes its own blocks of the cache,
        # laid out as the dry run's (``cache_pspec``: batch over "data",
        # kv heads or the sequence over "model"; the position tracks
        # replicated), each leaf at the empty cache's value
        mesh = tokens.device_mesh
        dev = tokens.to_local().device
        with FakeTensorMode():
            shapes = make(dev)
        cache = tree.map_nested(lambda t, fill: empty_on_mesh(
            t.shape, t.dtype, cache_pspec(tuple(t.shape), mesh_shape(mesh),
                                          include_pod=False)
            if t.is_floating_point() else (None,) * t.dim(), mesh,
            fill=fill, device=dev), shapes, _cache_fills(cfg))
    else:
        cache = make(tokens.device)
    logits, cache, _ = forward(params, cfg, tokens, extra=extra, cache=cache,
                               cache_pos=0, window=window or None,
                               groups=groups)
    return logits, cache


def decode_step(params, cfg, cache, tokens, pos, *, window: int = 0,
                page_table=None, groups: int = 1):
    """One decode step. tokens: (B, 1); pos: the absolute position (an
    int). Returns (logits, cache), the cache written in place."""
    logits, cache, _ = forward(params, cfg, tokens, cache=cache,
                               cache_pos=pos, window=window or None,
                               page_table=page_table, groups=groups)
    return logits, cache
