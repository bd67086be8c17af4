"""The stacked-layer LM (dense family): ``make_plan``, ``init_params``,
``forward`` without a cache and ``loss_fn``, as in the JAX
``models/model.py``.

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


def forward(params, cfg, tokens, *, window=None):
    """tokens: (B, S) integer. Returns (logits (B, S, V) float32, None,
    aux) like the JAX forward without a cache; aux is 0 for dense."""
    plan = make_plan(cfg)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    positions = torch.arange(S, device=tokens.device)
    # unbind each stack once: its backward stacks the per-layer grads in
    # one op (indexing layer by layer would build a full-size zero grad
    # per layer)
    stacks = [_unbind(params[f"stack{i}"], plan.n_groups)
              for i in range(len(plan.pattern))]

    def group_body(x, lps):
        for i, kind in enumerate(plan.pattern):
            x = BLK.apply_block(lps[i], x, cfg, kind, positions=positions,
                                window=window)
        return x

    for g in range(plan.n_groups):
        lps = [stack[g] for stack in stacks]
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(group_body, x, lps, use_reentrant=False)
        else:
            x = group_body(x, lps)
    x = L.apply_norm(params["ln_f"], x, cfg.norm)
    logits = L.lm_logits(params.get("head", {}), params["embed"], x, cfg)
    return logits, None, torch.zeros((), device=logits.device)


def _unbind(stack, n):
    """Tree of (n, ...) leaves -> list of n trees of per-layer slices."""
    per_leaf = tree.map(lambda a: torch.unbind(a, 0), stack)
    return [tree.map(lambda t: t[g], per_leaf) for g in range(n)]


def loss_fn(params, cfg, batch):
    logits, _, aux = forward(params, cfg, batch["tokens"])
    ce = L.next_token_loss(logits, batch["tokens"])
    total = ce + cfg.router_aux_coef * aux
    return total, {"loss": ce, "aux": aux}
