"""xLSTM blocks, as the JAX ``models/xlstm.py``: mLSTM (matrix memory) and
sLSTM (scalar memory) with exponential gating and the max-stabiliser
state m (−1e30 at the start), forget-gate biases +3.

The JAX ``lax.scan`` over time is a Python loop over the T cell steps;
decode is the same cell at T = 1. Each step is a dozen small ops, so the
recurrence is launch-bound on a GPU. On an island's DTensors (FSDP×TP)
each rank runs its own block of the inner width on plain tensors
(``_mlstm_on_mesh``, ``_slstm_on_mesh``): no collective inside the loop.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.spec import constrain, is_dtensor, mark_blocks
from .layers import (_count, _local_partial, apply_norm, dense_init,
                     ones_init, residual_spec, whole_features, zeros_init)

M_INIT = -1e30          # the stabiliser's start


def shift_free(path: str) -> bool:
    """Whether a param leaf (its dotted path) is an xLSTM cell's input-gate
    bias ``bi``, on which the loss does not depend: a shift δ of every
    token's input-gate pre-activation shifts the stabiliser m by δ too
    (m = max(log f + m_prev, i), from −1e30), so the gates exp(i − m) and
    exp(log f + m_prev − m), the states and the output do not change. Its
    exact gradient is 0, and a computed one is round-off of the terms
    that cancel in it."""
    return path.endswith("cell.bi")


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
    a cache), else ``init_mlstm_state``. Returns (out, new_state). On an
    island's DTensors each rank runs its own value columns
    (``_mlstm_on_mesh``)."""
    if is_dtensor(x):
        return _mlstm_on_mesh(p, x, cfg, state=state)
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
    """xt: {"z", "i", "f", "o"} pre-activations (B, H·dh) at one t, of the
    H heads of ``p``'s recurrent weights ((H, dh, dh) each); carry: (c, n,
    h, m) with c, n, m (B, H, dh) and h (B, H·dh). Returns (carry, h)."""
    c, n, h, m = carry
    B = xt["z"].shape[0]
    H, dh = p["rz"].shape[0], p["rz"].shape[-1]     # the heads it runs
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
    """x: (B, T, D); ``state`` (c, n, h, m) carried, else
    ``init_slstm_state``. Returns (out, new_state). On an island's
    DTensors each rank runs the heads its block of the inner width touches
    (``_slstm_on_mesh``)."""
    if is_dtensor(x):
        return _slstm_on_mesh(p, x, cfg, state=state)
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


# ---------------------------------------------------------------------------
# on an island's DTensors
# ---------------------------------------------------------------------------

class _Island:
    """Where an xLSTM cell runs on an island mesh. JAX's layouts
    (``param_pspec``) cut the inner width D = H·dh into contiguous blocks
    over "model" (``wz``, ``wo`` and the sLSTM's projections): rank r owns
    columns [r·w, (r+1)·w), w = D / model. That block is ``Hl`` whole
    heads where "model" divides H, and ``dvl`` of one head's dh columns
    where H divides "model" (``rr`` ranks share a head); ``h0`` is its
    first head and ``off`` its first column within the heads' block. On a
    mesh whose "model" axis has one rank or holds the batch (``pure_dp``)
    every rank runs all heads. Work is marked (``spec.mark_blocks``) as
    one of ``nb`` blocks (a rank's own columns), ``nh`` (the heads it
    runs: ranks that share a head repeat it) or ``nb_rows`` (its batch
    rows)."""

    def __init__(self, x, cfg):
        self.mesh = mesh = x.device_mesh
        self.mi = mi = list(mesh.mesh_dim_names).index("model")
        self.xf = whole_features(x, cfg)      # rows on their axes, all of D
        self.rows = [i for i, q in enumerate(self.xf.placements)
                     if q.is_shard()]
        self.split = mi not in self.rows and mesh.size(mi) > 1
        n = mesh.size(mi) if self.split else 1
        D, H = cfg.d_model, cfg.n_heads
        self.D, self.H, self.dh = D, H, D // H
        if D % n or (H % n and n % H):
            raise ValueError(f"xLSTM on an island: {H} heads of {D // H} "
                             f"cannot be cut {n} ways")
        self.r = mesh.get_local_rank(mi) if self.split else 0
        self.w = D // n
        self.Hl, self.rr = max(1, H // n), max(1, n // H)
        self.dvl = self.w // self.Hl
        self.h0 = self.r * self.w // self.dh
        self.off = self.r * self.w - self.h0 * self.dh
        self.nb_rows = math.prod(mesh.size(i) for i in self.rows)
        self.nb = self.nb_rows * n
        self.nh = self.nb_rows * (n // self.rr)
        self.grad_axes = sorted(set(self.rows) | ({mi} if self.split
                                                   else set()))

    def lay(self, q=None):
        """The activations' placements, "model" set to ``q`` (default
        ``Replicate()``) where the inner width is split over it."""
        from torch.distributed.tensor import Replicate
        q = Replicate() if q is None else q
        pl = list(self.xf.placements)
        if self.split:
            pl[self.mi] = q
        return pl

    def x_local(self):
        """This rank's rows of x with all of D (read by every model rank
        for its own block: its gradient is partial over "model"), and the
        same rows marked as read for this rank's own columns (a weight
        gradient xᵀ·g of them counts for every block: g may come from a
        collective, which marks nothing)."""
        xl = mark_blocks(self.nb_rows, _local_partial(
            self.xf, [self.mi] if self.split else []))[0]
        return xl, mark_blocks(self.nb, xl.view_as(xl))[0]

    def whole(self, t):
        """A weight every rank reads whole (each for its own block, on its
        own rows: its gradient is partial over both)."""
        from torch.distributed.tensor import Replicate
        t = t.redistribute(self.mesh, [Replicate()] * self.mesh.ndim)
        return _local_partial(t, self.grad_axes)

    def heads(self, t, dim=1):
        """The heads [h0, h0 + Hl) of a leaf's heads dim ``dim``, from the
        whole leaf."""
        return mark_blocks(self.nh, self.whole(t).narrow(
            dim, self.h0, self.Hl))[0]

    def cols(self, t):
        """This rank's block of a (D,) or (D, H, dh) leaf's inner width,
        from the whole leaf."""
        t = self.whole(t)
        t = t.reshape(t.shape[0], self.D) if t.dim() == 3 else t
        return mark_blocks(self.nb, t[..., self.r * self.w:
                                      (self.r + 1) * self.w])[0]

    def own(self, t, dim):
        """A leaf laid out with its inner width ``dim`` over "model"
        (``param_pspec``'s "inner"): this rank's block of it, its FSDP
        shards gathered."""
        from torch.distributed.tensor import Replicate, Shard
        pl = [Replicate()] * self.mesh.ndim
        if self.split:
            pl[self.mi] = Shard(dim)
        t = t.redistribute(self.mesh, pl)
        return mark_blocks(self.nb, _local_partial(t, self.rows))[0]

    def reduced(self, t):
        """A (B_l, T, 1) partial sum over "model" reduced (float32), as the
        whole width's sum on every rank."""
        from torch.distributed.tensor import DTensor, Partial
        if self.split:
            t = _local_partial(DTensor.from_local(
                t, self.mesh, self.lay(Partial()), run_check=False)
                .redistribute(self.mesh, self.xf.placements), [self.mi])
        return mark_blocks(self.nb_rows, t)[0]

    def rms_norm(self, h, scale):
        """``apply_norm``'s RMSNorm over all of D of this rank's columns
        ``h`` (B_l, T, w): the sum of squares reduced over "model"."""
        g = h.float()
        ssq = self.reduced(g.square().sum(-1, keepdim=True))
        return (g * torch.rsqrt(ssq / self.D + 1e-6)
                * self.own(scale, 0).float()).to(h.dtype)

    def out(self, h, w, cfg):
        """``h @ w`` of this rank's columns and ``w``'s own rows: a partial
        sum over "model", reduced into the residual stream's layout."""
        from torch.distributed.tensor import DTensor, Partial
        o = h @ self.own(w.to(h.dtype), 0)
        o = DTensor.from_local(o, self.mesh, self.lay(Partial()),
                               run_check=False)
        return constrain(o, residual_spec(cfg))

    def head_state(self, t, flat=False):
        """A cached (B, H, ...) state leaf, or a ``flat`` (B, H·dh) one, as
        this rank's rows of the heads it runs, (B_l, Hl, ...) (gathered
        over "model")."""
        t = t.redistribute(self.mesh, self.lay()).to_local()
        if flat:
            t = t.reshape(t.shape[0], self.H, self.dh)
        return t[:, self.h0:self.h0 + self.Hl]

    def cached(self, t, like):
        """This rank's (B_l, Hl, ...) state of its heads as a DTensor laid
        out as the cache leaf ``like`` ((B, H, ...) or (B, H·dh)): the
        heads gathered over "model" (the ranks that share one hold the
        same), then cut as ``like`` is."""
        from torch.distributed.tensor import DTensor, Shard
        if self.split:
            t = DTensor.from_local(t, self.mesh, self.lay(Shard(1)),
                                   run_check=False).redistribute(
                self.mesh, self.lay()).to_local()
            t = t[:, ::self.rr]
        t = t.reshape((t.shape[0],) + tuple(like.shape[1:]))
        return DTensor.from_local(t, self.mesh, self.lay(),
                                  run_check=False).redistribute(
            self.mesh, like.placements)


def _matrix_state_in(isl, C):
    """The cached matrix memory C (B, H, dk, dv) (``cache_pspec``'s layout:
    dk over "model") as this rank's (B_l, Hl, dk, dvl): viewed as (B, dk,
    H·dv), its inner width moved over "model" (an all-to-all)."""
    from torch.distributed.tensor import Shard
    B, H, dk, dv = C.shape
    loc = C.permute(0, 2, 1, 3).reshape(B, dk, H * dv).redistribute(
        isl.mesh, isl.lay(Shard(2))).to_local()
    return loc.reshape(loc.shape[0], dk, isl.Hl, isl.dvl).permute(0, 2, 1, 3)


def _matrix_state_out(isl, C, like):
    """This rank's (B_l, Hl, dk, dvl) back in the layout of the cache leaf
    ``like`` (B, H, dk, dv), through the (B, dk, H·dv) view."""
    from torch.distributed.tensor import DTensor, Shard
    B, H, dk, dv = like.shape
    view = {0: 0, 1: 2, 2: 1}                 # a dim of C -> of the view
    pl = []
    for q in like.placements:
        if q.is_shard() and q.dim not in view:
            raise ValueError(f"xLSTM on an island: a cache laid out "
                             f"{like.placements} has its dv sharded")
        pl.append(Shard(view[q.dim]) if q.is_shard() else q)
    loc = C.permute(0, 2, 1, 3).reshape(C.shape[0], dk, isl.w)
    return DTensor.from_local(loc, isl.mesh, isl.lay(Shard(2)),
                              run_check=False).redistribute(
        isl.mesh, pl).reshape(B, dk, H, dv).permute(0, 2, 1, 3)


def _mlstm_on_mesh(p, x, cfg, *, state=None):
    """``apply_mlstm`` on an island's DTensors: each rank runs the value
    columns of its block of D (``_Island``) on its own batch rows, the
    cell on plain tensors. The cell decomposes exactly over value columns
    (C·q and k⊗v are per column; n, m and |n·q| per head, which the ranks
    sharing a head each compute): a rank reads q, k, i and f of its heads
    and v of its own columns, from ``wq``, ``wk``, ``wv``, ``wi``, ``wf``
    gathered whole (their heads dim does not divide "model" at
    xlstm_350m's width), and holds C as (B_l, Hl, dk, dvl). After the loop
    the RMSNorm's sum of squares is reduced over "model" in float32, z is
    ``wz``'s own columns, and ``wo``'s own rows give a partial sum reduced
    into the residual stream. A cached state is brought from
    ``cache_pspec``'s layout to the cell's and back at each call."""
    isl = _Island(x, cfg)
    dt_ = x.dtype
    T = x.shape[1]
    Bl = isl.xf.to_local().shape[0]
    dh, Hl, dvl = isl.dh, isl.Hl, isl.dvl
    _count(7)
    xl, xo = isl.x_local()
    q = torch.einsum("btd,dhk->bthk", xl, isl.heads(p["wq"].to(dt_))) \
        * dh ** -0.5
    k = torch.einsum("btd,dhk->bthk", xl, isl.heads(p["wk"].to(dt_))) \
        * dh ** -0.5
    v = (xo @ isl.cols(p["wv"].to(dt_))).reshape(Bl, T, Hl, dvl)
    i_pre = (xl @ isl.heads(p["wi"].to(dt_))
             + isl.heads(p["bi"].to(dt_), 0)).float()
    f_pre = (xl @ isl.heads(p["wf"].to(dt_))
             + isl.heads(p["bf"].to(dt_), 0)).float()
    dev = xl.device
    if state is None:
        st = (torch.zeros((Bl, Hl, dh, dvl), device=dev),
              torch.zeros((Bl, Hl, dh), device=dev),
              torch.full((Bl, Hl), M_INIT, device=dev))
    else:
        st = (_matrix_state_in(isl, state[0]), isl.head_state(state[1]),
              isl.head_state(state[2]))
    mark_blocks(isl.nb, st[0])
    mark_blocks(isl.nh, *st[1:])
    steps = zip(*(torch.unbind(a, 1) for a in
                  (q.float(), k.float(), v.float(), i_pre, f_pre)))
    hs = []
    for xt in steps:
        st, h = mlstm_cell(st, xt)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(Bl, T, isl.w).to(dt_)
    z = xo @ isl.own(p["wz"].to(dt_), 1)
    o = isl.out(isl.rms_norm(h, p["norm"]) * F.silu(z), p["wo"], cfg)
    if state is None:
        return o, st
    return o, (_matrix_state_out(isl, st[0], state[0]),
               isl.cached(st[1], state[1]), isl.cached(st[2], state[2]))


def _slstm_on_mesh(p, x, cfg, *, state=None):
    """``apply_slstm`` on an island's DTensors: the recurrence (``rz``,
    ``ri``, ``rf``, ``ro``) mixes all dh units of a head every token, so
    each rank runs the whole heads its block of D touches (those that
    share a head repeat its recurrence), on its own batch rows. Each rank
    computes its own columns of the four pre-activations (``wz``, ``wi``,
    ``wf``, ``wo`` cut by "inner"); where its block is part of a head the
    columns are gathered over "model", once a layer, and it takes its
    heads'. After the loop it keeps its own columns for the RMSNorm (the
    sum of squares reduced over "model") and ``w_down``'s own rows, a
    partial sum reduced into the residual stream. A cached state is read
    as the heads' rows and written back in ``cache_pspec``'s layout."""
    from torch.distributed.tensor import DTensor, Shard
    isl = _Island(x, cfg)
    dt_ = x.dtype
    Bl = isl.xf.to_local().shape[0]
    dh, Hl = isl.dh, isl.Hl
    _count(5)
    _, xo = isl.x_local()
    pre = {}
    for g in ("z", "i", "f", "o"):
        own = xo @ isl.own(p["w" + g].to(dt_), 1) + isl.cols(
            p["b" + g].to(dt_))
        if isl.rr > 1:                  # the heads' columns, once a layer
            own = _local_partial(DTensor.from_local(
                own, isl.mesh, isl.lay(Shard(2)), run_check=False)
                .redistribute(isl.mesh, isl.lay()),
                [isl.mi])[..., isl.h0 * dh:(isl.h0 + Hl) * dh]
        pre[g] = mark_blocks(isl.nh, own)[0].float()
    dev = xo.device
    if state is None:
        z = torch.zeros((Bl, Hl, dh), device=dev)
        st = (z, z.clone(), torch.zeros((Bl, Hl * dh), device=dev),
              torch.full((Bl, Hl, dh), M_INIT, device=dev))
    else:
        c, n, h, m = (isl.head_state(t, flat=i == 2)
                      for i, t in enumerate(state))
        st = (c, n, h.reshape(Bl, Hl * dh), m)
    mark_blocks(isl.nh, *st)
    rw = {k: isl.heads(p[k], 0).float() for k in ("rz", "ri", "rf", "ro")}
    per_t = {g: torch.unbind(a, 1) for g, a in pre.items()}
    hs = []
    for t in range(x.shape[1]):
        st, h = slstm_cell(rw, cfg, st, {g: a[t] for g, a in per_t.items()})
        hs.append(h)
    hs = mark_blocks(isl.nb, torch.stack(hs, 1)[
        ..., isl.off:isl.off + isl.w])[0].to(dt_)
    o = isl.out(isl.rms_norm(hs, p["norm"]), p["w_down"], cfg)
    if state is None:
        return o, st
    c, n, h, m = st
    return o, (isl.cached(c, state[0]), isl.cached(n, state[1]),
               isl.cached(h.reshape(Bl, Hl, dh), state[2]),
               isl.cached(m, state[3]))
