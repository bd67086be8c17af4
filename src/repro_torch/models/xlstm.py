"""xLSTM blocks, as the JAX ``models/xlstm.py``: mLSTM (matrix memory) and
sLSTM (scalar memory) with exponential gating and the max-stabiliser
state m (−1e30 at the start), forget-gate biases +3.

The JAX ``lax.scan`` over time is a Python loop over the T cell steps;
decode is the same cell at T = 1. Each step is a dozen small ops, so the
recurrence is launch-bound on a GPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _count, apply_norm, dense_init, ones_init, zeros_init

M_INIT = -1e30          # the stabiliser's start


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

MLSTM_AXES = {"wq": ("embed", "heads", None), "wk": ("embed", "heads", None),
              "wv": ("embed", "heads", None), "wi": ("embed", "heads"),
              "wf": ("embed", "heads"), "bi": ("heads",), "bf": ("heads",),
              "wz": ("embed", "inner"), "wo": ("inner", "embed"),
              "norm": (None,)}
SLSTM_AXES = {**{w: ("embed", "inner") for w in ("wz", "wi", "wf", "wo")},
              **{r: ("heads", None, None) for r in ("rz", "ri", "rf", "ro")},
              **{b: (None,) for b in ("bz", "bi", "bf", "bo", "norm")},
              "w_down": ("inner", "embed")}


def init_mlstm(gen, cfg, *, device, lead=()):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    init = lambda shape: dense_init(gen, shape, cfg.init_scale,
                                    device=device, lead=lead)
    return {"wq": init((D, H, dh)), "wk": init((D, H, dh)),
            "wv": init((D, H, dh)), "wi": init((D, H)), "wf": init((D, H)),
            "bi": zeros_init((H,), device=device, lead=lead),
            "bf": torch.full(tuple(lead) + (H,), 3.0, device=device),
            "wz": init((D, D)), "wo": init((D, D)),
            "norm": ones_init((D,), device=device, lead=lead)}


def mlstm_cell(carry, inp):
    """One timestep. carry: (C, n, m) with C (B, H, dk, dv), n (B, H, dk),
    m (B, H); inp: (q, k, v, i_pre, f_pre) at one t. Returns (carry, h)."""
    C, n, m = carry
    q, k, v, i_pre, f_pre = inp
    # log-space stabilised exponential gating
    logf = F.logsigmoid(f_pre)                            # (B, H)
    m_new = torch.maximum(logf + m, i_pre)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(i_pre - m_new)
    C = C * fg[..., None, None] + ig[..., None, None] \
        * (k[..., :, None] * v[..., None, :])
    n = n * fg[..., None] + ig[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, q))
    h = num / torch.clamp(den, min=1.0)[..., None]
    return (C, n, m_new), h


def apply_mlstm(p, x, cfg, *, state=None):
    """x: (B, T, D); ``state`` (C, n, m) carried (decode or a prefill into
    a cache), else ``init_mlstm_state``. Returns (out, new_state)."""
    dt_ = x.dtype
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    _count(7)
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt_)) * dh ** -0.5
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dt_)) * dh ** -0.5
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dt_))
    i_pre = (x @ p["wi"].to(dt_) + p["bi"].to(dt_)).float()
    f_pre = (x @ p["wf"].to(dt_) + p["bf"].to(dt_)).float()
    if state is None:
        state = init_mlstm_state(cfg, B, dh, device=x.device)
    # unbind each input once: its backward stacks the per-token grads in
    # one op (slicing token by token would build a full-length zero grad
    # per token, bytes growing with T²)
    steps = zip(*(torch.unbind(a, 1) for a in
                  (q.float(), k.float(), v.float(), i_pre, f_pre)))
    hs = []
    for xt in steps:
        state, h = mlstm_cell(state, xt)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, T, D).to(dt_)
    z = x @ p["wz"].to(dt_)
    h = apply_norm({"scale": p["norm"]}, h, "rmsnorm") * F.silu(z)
    return h @ p["wo"].to(dt_), state


def init_mlstm_state(cfg, batch: int, dh: int | None = None, *, device):
    H = cfg.n_heads
    dh = dh or cfg.d_model // H
    return (torch.zeros((batch, H, dh, dh), device=device),
            torch.zeros((batch, H, dh), device=device),
            torch.full((batch, H), M_INIT, device=device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg, *, device, lead=()):
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    mk = lambda: dense_init(gen, (D, D), cfg.init_scale, device=device,
                            lead=lead)
    rk = lambda: dense_init(gen, (H, dh, dh), cfg.init_scale, device=device,
                            lead=lead)
    zeros = lambda: zeros_init((D,), device=device, lead=lead)
    return {"wz": mk(), "wi": mk(), "wf": mk(), "wo": mk(),
            "rz": rk(), "ri": rk(), "rf": rk(), "ro": rk(),
            "bz": zeros(), "bi": zeros(),
            "bf": torch.full(tuple(lead) + (D,), 3.0, device=device),
            "bo": zeros(),
            "w_down": dense_init(gen, (D, D), cfg.init_scale, device=device,
                                 lead=lead),
            "norm": ones_init((D,), device=device, lead=lead)}


def slstm_cell(p, cfg, carry, xt):
    """xt: {"z", "i", "f", "o"} pre-activations (B, D) at one t; carry:
    (c, n, h, m) with c, n, m (B, H, dh) and h (B, H·dh). Returns (carry,
    h)."""
    c, n, h, m = carry
    B = xt["z"].shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    hh = h.reshape(B, H, dh)
    rec = lambda w: torch.einsum("bhk,hkl->bhl", hh, w)
    z = torch.tanh(xt["z"].reshape(B, H, dh) + rec(p["rz"]))
    i_pre = xt["i"].reshape(B, H, dh) + rec(p["ri"])
    f_pre = xt["f"].reshape(B, H, dh) + rec(p["rf"])
    o = torch.sigmoid(xt["o"].reshape(B, H, dh) + rec(p["ro"]))
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(i_pre - m_new)
    c = fg * c + ig * z
    n = fg * n + ig
    h_new = (o * c / torch.clamp(n, min=1.0)).reshape(B, H * dh)
    return (c, n, h_new, m_new), h_new


def apply_slstm(p, x, cfg, *, state=None):
    dt_ = x.dtype
    B, T, D = x.shape
    _count(5)
    pre = {g: (x @ p["w" + g].to(dt_) + p["b" + g].to(dt_)).float()
           for g in ("z", "i", "f", "o")}
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    pf32 = {k: p[k].float() for k in ("rz", "ri", "rf", "ro")}
    # one unbind per gate, as in ``apply_mlstm``
    per_t = {g: torch.unbind(a, 1) for g, a in pre.items()}
    hs = []
    for t in range(T):
        state, h = slstm_cell(pf32, cfg, state,
                              {g: a[t] for g, a in per_t.items()})
        hs.append(h)
    hs = apply_norm({"scale": p["norm"]}, torch.stack(hs, 1).to(dt_),
                    "rmsnorm")
    return hs @ p["w_down"].to(dt_), state


def init_slstm_state(cfg, batch: int, *, device):
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), device=device)
    return (z, z.clone(), torch.zeros((batch, H * dh), device=device),
            torch.full((batch, H, dh), M_INIT, device=device))
