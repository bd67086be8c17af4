"""Residual blocks of every architecture family (the JAX
``models/blocks.py``), with their decode caches. A block kind is a string:

  attn_mlp        pre-norm self-attention + (MLP | MoE)     [dense & MoE LMs]
  mla_moe         MLA self-attention + MoE                  [deepseek-v2]
  cross_mlp       tanh-gated cross-attention + MLP          [VLM layers]
  self_cross_mlp  self-attn + cross-attn + MLP              [whisper decoder]
  enc_attn_mlp    bidirectional self-attention + MLP        [whisper encoder]
  mamba2          Mamba2 SSD mixer                          [zamba2]
  mlstm / slstm   xLSTM cells                               [xlstm]

``apply_block`` returns (x, cache, aux): the cache (see
``init_block_cache``) is written in place, and aux is the MoE
load-balancing loss (0 elsewhere).
"""
from __future__ import annotations

import torch

from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL

def init_block(gen, cfg, kind: str, *, device, lead=()):
    kw = dict(device=device, lead=lead)
    n = lambda: L.init_norm(cfg.norm, cfg.d_model, **kw)
    if kind in ("attn_mlp", "enc_attn_mlp"):
        p = {"ln1": n(), "attn": L.init_attention(gen, cfg, **kw), "ln2": n()}
        if kind == "attn_mlp" and cfg.n_experts:
            p["moe"] = MOE.init_moe(gen, cfg, **kw)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, **kw)
        return p
    if kind == "mla_moe":
        return {"ln1": n(), "mla": MLA.init_mla(gen, cfg, **kw),
                "ln2": n(), "moe": MOE.init_moe(gen, cfg, **kw)}
    if kind == "cross_mlp":
        return {"ln1": n(), "xattn": L.init_attention(gen, cfg, **kw),
                "ln2": n(), "mlp": L.init_mlp(gen, cfg, **kw),
                "gate_attn": L.zeros_init((1,), **kw),
                "gate_mlp": L.zeros_init((1,), **kw)}
    if kind == "self_cross_mlp":
        return {"ln1": n(), "attn": L.init_attention(gen, cfg, **kw),
                "ln2": n(), "xattn": L.init_attention(gen, cfg, **kw),
                "ln3": n(), "mlp": L.init_mlp(gen, cfg, **kw)}
    if kind == "mamba2":
        return {"ln1": n(), "mixer": SSM.init_mamba2(gen, cfg, **kw)}
    if kind == "mlstm":
        return {"ln1": n(), "cell": XL.init_mlstm(gen, cfg, **kw)}
    if kind == "slstm":
        return {"ln1": n(), "cell": XL.init_slstm(gen, cfg, **kw)}
    raise ValueError(kind)


def block_axes(kind: str) -> dict:
    """The logical axes of every leaf ``init_block`` may give a ``kind``
    block (a superset of any one config's keys)."""
    n, mlp = L.NORM_AXES, L.MLP_AXES
    if kind in ("attn_mlp", "enc_attn_mlp"):
        return {"ln1": n, "attn": L.ATTENTION_AXES, "ln2": n, "mlp": mlp,
                "moe": MOE.MOE_AXES}
    if kind == "mla_moe":
        return {"ln1": n, "mla": MLA.MLA_AXES, "ln2": n, "moe": MOE.MOE_AXES}
    if kind == "cross_mlp":
        return {"ln1": n, "xattn": L.ATTENTION_AXES, "ln2": n, "mlp": mlp,
                "gate_attn": (None,), "gate_mlp": (None,)}
    if kind == "self_cross_mlp":
        return {"ln1": n, "attn": L.ATTENTION_AXES, "ln2": n,
                "xattn": L.ATTENTION_AXES, "ln3": n, "mlp": mlp}
    if kind == "mamba2":
        return {"ln1": n, "mixer": SSM.MAMBA2_AXES}
    if kind in ("mlstm", "slstm"):
        return {"ln1": n, "cell": XL.MLSTM_AXES if kind == "mlstm"
                else XL.SLSTM_AXES}
    raise ValueError(kind)


def _store(dst, src):
    """Write a recurrent state (a tensor or a tuple of them) into the
    cache's tensors in place."""
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


def apply_block(p, x, cfg, kind: str, *, positions, cache=None,
                cache_pos=None, kv_x=None, groups: int = 1, window=None,
                page_table=None):
    """One residual block. ``window`` overrides cfg.window when not None;
    ``kv_x``: the cross-attention source (train and prefill of the
    cross-attention kinds)."""
    win = cfg.window if window is None else window
    aux = torch.zeros((), device=x.device)
    norm = lambda q, xx: L.apply_norm(p[q], xx, cfg.norm)

    if kind in ("attn_mlp", "enc_attn_mlp"):
        h = norm("ln1", x)
        a, _ = L.apply_attention(
            p["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            cache_pos=cache_pos, window=win, causal=kind == "attn_mlp",
            page_table=page_table)
        if cfg.parallel_block:
            return x + a + L.apply_mlp(p["mlp"], h, cfg), cache, aux
        x = x + a
        h2 = norm("ln2", x)
        if "moe" in p:
            m, aux = MOE.apply_moe(p["moe"], h2, cfg, groups=groups)
        else:
            m = L.apply_mlp(p["mlp"], h2, cfg)
        return x + m, cache, aux

    if kind == "mla_moe":
        h = norm("ln1", x)
        a, _ = MLA.apply_mla(p["mla"], h, cfg, positions=positions,
                             cache=None if cache is None else cache["mla"],
                             cache_pos=cache_pos)
        x = x + a
        m, aux = MOE.apply_moe(p["moe"], norm("ln2", x), cfg, groups=groups)
        return x + m, cache, aux

    if kind == "cross_mlp":
        # gated cross-attention (llama-3.2-vision style): tanh-gated
        # residuals
        h = norm("ln1", x)
        xkv = _cross_kv(p["xattn"], cfg, kv_x, cache)
        a, _ = L.apply_attention(p["xattn"], h, cfg, positions=positions,
                                 causal=False, cross_kv=xkv, window=0)
        x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * a
        m = L.apply_mlp(p["mlp"], norm("ln2", x), cfg)
        return x + torch.tanh(p["gate_mlp"]).to(x.dtype) * m, cache, aux

    if kind == "self_cross_mlp":
        h = norm("ln1", x)
        a, _ = L.apply_attention(
            p["attn"], h, cfg, positions=positions,
            cache=None if cache is None else cache["attn"],
            cache_pos=cache_pos, window=win, causal=True,
            page_table=page_table)
        x = x + a
        xkv = _cross_kv(p["xattn"], cfg, kv_x, cache)
        a2, _ = L.apply_attention(p["xattn"], norm("ln2", x), cfg,
                                  positions=positions, causal=False,
                                  cross_kv=xkv, window=0)
        x = x + a2
        return x + L.apply_mlp(p["mlp"], norm("ln3", x), cfg), cache, aux

    if kind == "mamba2":
        o, (ns, nt) = SSM.apply_mamba2(
            p["mixer"], norm("ln1", x), cfg,
            state=None if cache is None else cache["ssm"],
            conv_tail=None if cache is None else cache["conv"])
        if cache is not None:
            _store(cache["ssm"], ns)
            _store(cache["conv"], nt)
        return x + o, cache, aux

    if kind in ("mlstm", "slstm"):
        fn = XL.apply_mlstm if kind == "mlstm" else XL.apply_slstm
        o, ns = fn(p["cell"], norm("ln1", x), cfg,
                   state=None if cache is None else cache["state"])
        if cache is not None:
            _store(cache["state"], ns)
        return x + o, cache, aux

    raise ValueError(kind)


def _cross_kv(p, cfg, kv_x, cache):
    """The cross K/V: projected from ``kv_x`` (and cached, in place, when
    there is a cache), or read back from the cache at decode."""
    if kv_x is not None:
        xk, xv = L.project_cross_kv(p, cfg, kv_x)
        if cache is not None:
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
        return xk, xv
    if cache is not None and "xk" in cache:
        return cache["xk"], cache["xv"]
    raise ValueError("cross-attention needs kv_x (train/prefill) or a "
                     "prefilled cache (decode)")


def init_block_cache(cfg, kind: str, batch: int, cache_len: int, dtype, *,
                     device):
    """An empty decode cache for one block of ``kind``."""
    hd, G = cfg.resolved_head_dim, cfg.n_kv_heads
    zeros = lambda n: torch.zeros((batch, n, G, hd), dtype=dtype,
                                  device=device)
    attn = lambda: L.init_attn_cache(cfg, batch, cache_len, dtype,
                                     device=device)
    if kind == "self_cross_mlp":
        return {"attn": attn(), "xk": zeros(cfg.n_frames),
                "xv": zeros(cfg.n_frames)}
    if kind == "cross_mlp":
        return {"xk": zeros(cfg.n_patches), "xv": zeros(cfg.n_patches)}
    if kind in ("attn_mlp", "enc_attn_mlp"):
        return {"attn": attn()}
    if kind == "mla_moe":
        return {"mla": MLA.init_mla_cache(cfg, batch, cache_len, dtype,
                                          device=device)}
    if kind == "mamba2":
        s, t = SSM.init_mamba2_state(cfg, batch, dtype, device=device)
        return {"ssm": s, "conv": t}
    if kind == "mlstm":
        return {"state": XL.init_mlstm_state(cfg, batch, device=device)}
    if kind == "slstm":
        return {"state": XL.init_slstm_state(cfg, batch, device=device)}
    return {}


def init_paged_block_cache(cfg, kind: str, batch: int, cache_len: int,
                           dtype, *, n_pages: int, page_size: int, device):
    """The paged variant of ``init_block_cache``: the self-attention rings
    live in one shared page pool (the engine's page table maps each slot's
    logical ring pages to pool pages); every other leaf (SSM and xLSTM
    states, MLA latent rings, cross K/V) keeps its per-slot row."""
    if kind in ("attn_mlp", "enc_attn_mlp", "self_cross_mlp"):
        c = {"attn": L.init_paged_attn_cache(cfg, n_pages, page_size, dtype,
                                             device=device)}
        if kind == "self_cross_mlp":
            G, hd = cfg.n_kv_heads, cfg.resolved_head_dim
            c["xk"] = torch.zeros((batch, cfg.n_frames, G, hd), dtype=dtype,
                                  device=device)
            c["xv"] = torch.zeros_like(c["xk"])
        return c
    return init_block_cache(cfg, kind, batch, cache_len, dtype, device=device)


def stacked_init(gen, cfg, kind: str, count: int, *, device):
    """``count`` layers of one kind, each leaf with a leading (count,)
    dim (the JAX ``stacked_init`` layout)."""
    return init_block(gen, cfg, kind, device=device, lead=(count,))
