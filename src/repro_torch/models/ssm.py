"""Mamba2 (SSD, state-space duality) blocks, as the JAX ``models/ssm.py``.

Training and prefill run the chunked SSD algorithm: a within-chunk
quadratic (attention-like) term plus a linear recurrence between chunks,
the JAX ``lax.scan`` over chunks a Python loop here. Decode is the exact
one-token recurrence on a constant (B, H, N, P) state and a (conv
width − 1)-deep causal-conv tail. On an island's DTensors (FSDP×TP) each
rank runs its own heads (``_mamba2_on_mesh``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding.spec import constrain, is_dtensor, mark_blocks
from .layers import (_count, _local_partial, apply_norm, dense_init,
                     f32_product, ones_init, residual_spec, whole_features,
                     zeros_init)


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_inner // 64)
    return d_inner, H, cfg.ssm_state


MAMBA2_AXES = {"in_proj": ("embed", "inner"), "out_proj": ("inner", "embed"),
               "conv_w": (None, "inner"), "conv_b": ("inner",),
               "A_log": (None,), "D": (None,), "dt_bias": (None,),
               "norm": ("inner",)}


def init_mamba2(gen, cfg, *, device, lead=()):
    D = cfg.d_model
    d_inner, H, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    # in_proj -> [z(d_inner), x(d_inner), B(N), C(N), dt(H)]
    d_in_total = 2 * d_inner + 2 * N + H
    init = lambda shape, scale: dense_init(gen, shape, scale, device=device,
                                           lead=lead)
    return {"in_proj": init((D, d_in_total), cfg.init_scale),
            "out_proj": init((d_inner, D), cfg.init_scale),
            "conv_w": init((cfg.ssm_conv, conv_ch), 0.2),
            "conv_b": zeros_init((conv_ch,), device=device, lead=lead),
            "A_log": init((H,), 1.0),
            "D": ones_init((H,), device=device, lead=lead),
            "dt_bias": zeros_init((H,), device=device, lead=lead),
            "norm": ones_init((d_inner,), device=device, lead=lead)}


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv with SiLU. x: (B, T, C); w: (W, C); tail:
    (B, W−1, C), the carried history (zeros when None). Returns (y,
    new_tail)."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[-1]))
    xp = torch.cat([tail, x], dim=1)
    T = x.shape[1]
    y = sum(xp[:, i:i + T] * w[i] for i in range(W)) + b
    new_tail = xp[:, -(W - 1):] if W > 1 else tail
    return F.silu(y), new_tail


def ssd_chunked(x, dt, A, Bm, Cm, Dp, chunk: int):
    """SSD scan. x: (B, T, H, P); dt: (B, T, H) (after softplus); A: (H,)
    < 0; Bm, Cm: (B, T, N); Dp: (H,). Returns y (B, T, H, P) and the final
    state (B, H, N, P) float32. A T that is no multiple of ``chunk`` runs
    as chunks of 1 (T < chunk) or one chunk of T, as the JAX package does.
    The three-operand contractions go pairwise, never through a
    (b, c, i, j, h, p) tensor; B and C meet the float32 states as float32
    (the JAX einsum promotes a bf16 operand there)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if T % chunk != 0:
        chunk = 1 if T < chunk else T
    nc, cs = T // chunk, chunk

    dA = dt * A[None, None]                                   # (B,T,H) <= 0
    xdt = x * dt[..., None]
    r = lambda a: a.reshape(Bsz, nc, cs, *a.shape[2:])
    dAc, xc, Bc, Cc = r(dA), r(xdt), r(Bm), r(Cm)
    cum = torch.cumsum(dAc, dim=2)                            # (B,nc,cs,H)
    cum_end = cum[:, :, -1]                                   # (B,nc,H)

    # within-chunk (diagonal) term; masked BEFORE exp (an unmasked seg > 0
    # would overflow and poison the backward with inf · 0)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,i,j,H)
    ii = torch.arange(cs, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    seg = torch.where(causal, seg, torch.full((), -torch.inf,
                                              device=x.device))
    Lmat = torch.exp(seg)
    _count(4)
    scores = f32_product("bcin,bcjn->bcij", Cc, Bc)
    ydiag = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * Lmat,
                         xc).float()

    # each chunk's input state: sum_j exp(cum_end − cum_j) B_j (dt_j x_j)
    decay_in = torch.exp(cum_end[:, :, None] - cum)           # (B,nc,cs,H)
    chunk_states = torch.einsum("bcjn,bcjhp->bchnp", Bc.float(),
                                decay_in[..., None] * xc).float()

    # the recurrence between chunks: each chunk reads the state before it
    state = x.new_zeros((Bsz, H, N, P), dtype=torch.float32)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(cum_end[:, c])[..., None, None] \
            + chunk_states[:, c]
    prev_states = torch.stack(prev, 1)                        # (B,nc,H,N,P)

    # off-diagonal: y_i += exp(cum_i) C_i . state_prev
    yoff = torch.einsum("bcin,bchnp->bcihp", Cc.float(), prev_states) \
        * torch.exp(cum)[..., None]
    y = (ydiag + yoff).reshape(Bsz, T, H, P)
    y = y + x * Dp[None, None, :, None]
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, Bm, Cm, Dp, state):
    """One-token recurrence. x: (B, 1, H, P); dt: (B, 1, H); Bm, Cm: (B, 1,
    N); state: (B, H, N, P). Returns (y (B, 1, H, P), the new state)."""
    dA = torch.exp(dt[:, 0] * A[None])                        # (B,H)
    upd = torch.einsum("bn,bhp->bhnp", Bm[:, 0].float(),
                       dt[:, 0][..., None] * x[:, 0]).float()
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), state)
    y = y + x[:, 0] * Dp[None, :, None]
    return y[:, None].to(x.dtype), state


def apply_mamba2(p, x, cfg, *, state=None, conv_tail=None):
    """x: (B, T, D). With ``state`` and T == 1 the decode recurrence; else
    the chunked scan from a zero state (train, or a prefill, whose conv
    still starts from ``conv_tail``). Returns (out, (new_state,
    new_conv_tail)). On an island's DTensors each rank runs its own heads
    (``_mamba2_on_mesh``)."""
    if is_dtensor(x):
        return _mamba2_on_mesh(p, x, cfg, state=state, conv_tail=conv_tail)
    dt_ = x.dtype
    d_inner, H, N = _dims(cfg)
    _count(2)                               # in_proj, out_proj
    proj = x @ p["in_proj"].to(dt_)
    z = proj[..., :d_inner]
    conv_in = proj[..., d_inner:2 * d_inner + 2 * N]          # [x, B, C]
    dtr = proj[..., 2 * d_inner + 2 * N:]
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"].to(dt_),
                                      p["conv_b"].to(dt_), conv_tail)
    xc = conv_out[..., :d_inner]
    Bm = conv_out[..., d_inner:d_inner + N]
    Cm = conv_out[..., d_inner + N:]
    xh = xc.reshape(*xc.shape[:2], H, d_inner // H)
    dt_soft = F.softplus(dtr.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    Dp = p["D"].float()

    if state is not None and x.shape[1] == 1:
        y, new_state = ssd_decode_step(xh, dt_soft, A, Bm, Cm, Dp, state)
    else:
        y, new_state = ssd_chunked(xh, dt_soft, A, Bm, Cm, Dp, cfg.ssm_chunk)
    y = y.reshape(*y.shape[:2], d_inner)
    # gated RMSNorm (mamba2 style), then the down-projection
    y = apply_norm({"scale": p["norm"]}, y * F.silu(z), "rmsnorm")
    return y @ p["out_proj"].to(dt_), (new_state, new_tail)


def _mamba2_on_mesh(p, x, cfg, *, state=None, conv_tail=None):
    """``apply_mamba2`` on an island's DTensors: each rank runs its own
    heads (H / model of them, with their z, x and dt channels) and B and C
    whole, on its own batch rows; the scan is independent over the heads.

    The layouts are JAX's (``param_pspec``, ``cache_pspec``), and they do
    not follow the heads: ``in_proj``'s columns [z | x | B | C | dt] and
    the conv's channels [x | B | C] are cut into contiguous blocks over
    "model". So each rank gathers the whole (bf16) ``in_proj`` and conv
    weights (FSDP's gather and one over "model") and takes the columns of
    its own heads and a 1/model share of B and C; the shares of B and C
    (after the conv) are gathered over "model", so that every rank holds
    them whole and each of their products is counted once per batch
    block. ``out_proj``'s rows and ``norm`` are cut by "inner" and follow
    the heads: each rank reads its own block (``out_proj`` gathered over
    "data" only). The gated RMSNorm sums each rank's squares over "model"
    in float32; the output is a partial sum over "model", reduced into
    the residual stream's layout. A decode state laid out with N over
    "model" (``cache_pspec`` picks N before the heads) is brought to the
    heads' layout and back, and the conv tail gathered whole, at each
    call. On a mesh whose "model" axis has one rank, or holds the batch
    (``pure_dp``), every rank runs all heads. The local work is counted
    for every block it stands for (``spec.mark_blocks``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dt_ = x.dtype
    d_inner, H, N = _dims(cfg)
    P = d_inner // H
    mesh = x.device_mesh
    mi = list(mesh.mesh_dim_names).index("model")
    xf = whole_features(x, cfg)           # batch on its axes, whole features
    rows = [i for i, q in enumerate(xf.placements) if q.is_shard()]
    split = mi not in rows and mesh.size(mi) > 1
    n = mesh.size(mi) if split else 1
    if H % n or (2 * N) % n:
        raise ValueError(f"Mamba2 on an island: {H} heads and B, C of "
                         f"{N} channels each cannot be cut {n} ways")
    r = mesh.get_local_rank(mi) if split else 0
    Hl, k, w = H // n, 2 * N // n, H // n * P
    nb_rows = math.prod(mesh.size(i) for i in rows)
    nb = nb_rows * n
    grad_axes = sorted(set(rows) | ({mi} if split else set()))

    def lay(q):
        """The activations' layout, "model" set to ``q`` where the heads
        are split over it."""
        pl = list(xf.placements)
        if split:
            pl[mi] = q
        return pl

    def wlay(q):                            # a weight's: "model" alone
        pl = [Replicate()] * mesh.ndim
        pl[mi] = q
        return pl

    def whole(t):
        """A weight every rank reads whole (each for its own heads, on its
        own rows: its gradient is partial over both)."""
        t = t.redistribute(mesh, [Replicate()] * mesh.ndim)
        return _local_partial(t, grad_axes)

    dev = xf.to_local().device
    ar = lambda a, b: torch.arange(a, b, device=dev)
    hp, bc, hd = ar(r * w, r * w + w), ar(r * k, r * k + k), \
        ar(r * Hl, r * Hl + Hl)
    conv_cols = torch.cat([hp, d_inner + bc])
    _count(2)                               # in_proj, out_proj
    xl, = mark_blocks(nb, _local_partial(xf, [mi] if split else []))
    wl, = mark_blocks(nb, whole(p["in_proj"].to(dt_))[:, torch.cat(
        [hp, d_inner + conv_cols, 2 * d_inner + 2 * N + hd])])
    proj = xl @ wl                          # [z | x | B, C share | dt]
    z, conv_in, dtr = proj[..., :w], proj[..., w:2 * w + k], \
        proj[..., 2 * w + k:]
    cw, cb = mark_blocks(nb, whole(p["conv_w"].to(dt_))[:, conv_cols],
                         whole(p["conv_b"].to(dt_))[conv_cols])
    tail = None
    if conv_tail is not None:               # the tail whole, own channels
        tail = conv_tail.redistribute(mesh, lay(Replicate())).to_local()[
            ..., conv_cols]
    conv_out, new_tail = _causal_conv(conv_in, cw, cb, tail)
    xo, bcl = conv_out[..., :w], conv_out[..., w:]
    if split:                               # B and C whole on every rank
        bcl = _local_partial(DTensor.from_local(
            bcl, mesh, lay(Shard(2)), run_check=False).redistribute(
                mesh, xf.placements), [mi])
    mark_blocks(nb_rows, bcl)
    Bm, Cm = bcl[..., :N], bcl[..., N:]
    heads = lambda t: mark_blocks(nb, whole(t)[hd].float())[0]
    dt_soft = F.softplus(dtr.float() + heads(p["dt_bias"]))
    A = -torch.exp(heads(p["A_log"]))
    Dp = heads(p["D"])
    xh = xo.reshape(*xo.shape[:2], Hl, P)
    # a decode state in the heads' layout (batch as the rows, heads on
    # "model"), from the cache's and back
    st_pl = lay(Shard(1))
    if state is not None and x.shape[1] == 1:
        st = state.redistribute(mesh, st_pl).to_local()
        y, new_state = ssd_decode_step(xh, dt_soft, A, Bm, Cm, Dp, st)
    else:
        y, new_state = ssd_chunked(xh, dt_soft, A, Bm, Cm, Dp,
                                   cfg.ssm_chunk)
    y = y.reshape(*y.shape[:2], w)
    # gated RMSNorm (mamba2 style): the mean of squares over all of
    # d_inner, each rank's sum reduced over "model" in float32
    g = (y * F.silu(z)).float()
    ssq = g.square().sum(-1, keepdim=True)
    if split:
        ssq = _local_partial(DTensor.from_local(
            ssq, mesh, lay(Partial()), run_check=False).redistribute(
                mesh, xf.placements), [mi])
    scale = p["norm"].redistribute(mesh, wlay(
        Shard(0) if split else Replicate()))
    yn = (g * torch.rsqrt(ssq / d_inner + 1e-6)
          * mark_blocks(nb, _local_partial(scale, rows))[0].float()).to(dt_)
    wo = p["out_proj"].to(dt_).redistribute(mesh, wlay(
        Shard(0) if split else Replicate()))
    o = yn @ mark_blocks(nb, _local_partial(wo, rows))[0]
    o = DTensor.from_local(o, mesh, lay(Partial()), run_check=False)
    o = constrain(o, residual_spec(cfg))     # reduced into the stream
    if state is None and conv_tail is None:
        return o, (None, None)
    # the new state and tail written in the cache's layouts: the state
    # back to N over "model"; the tail's channels (each rank's own, in
    # rank order) gathered whole and put in [x | B | C] order
    new_state = DTensor.from_local(new_state, mesh, st_pl,
                                   run_check=False).redistribute(
        mesh, state.placements)
    if split:
        new_tail = DTensor.from_local(
            new_tail, mesh, lay(Shard(2)), run_check=False).redistribute(
                mesh, lay(Replicate())).to_local()
        order = torch.cat([torch.cat([ar(s * w, s * w + w),
                                      d_inner + ar(s * k, s * k + k)])
                           for s in range(n)])
        new_tail = new_tail[..., torch.argsort(order)]
    new_tail = DTensor.from_local(new_tail, mesh, lay(Replicate()),
                                  run_check=False).redistribute(
        mesh, conv_tail.placements)
    return o, (new_state, new_tail)


def init_mamba2_state(cfg, batch: int, dtype=torch.float32, *, device):
    d_inner, H, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    return (torch.zeros((batch, H, N, d_inner // H), device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                        device=device))
