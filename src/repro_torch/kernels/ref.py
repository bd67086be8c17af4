"""Plain PyTorch versions of the port's kernels.

Each optimizer and pruning function computes what its CUDA kernel
computes, with the same operation order, so that the kernel agrees with
it bit for bit on the card; the flash-attention functions compute the
kernels' maths on whole (Sq, Sk) score matrices and agree to a
tolerance. They are what the
kernel wrappers run on CPU tensors, what the CPU tests hold against the
JAX package, and what ``chip_smoke.py`` holds the kernels against.

Scalars are rounded to float32 once (as JAX's weak typing does) and the
divisors are 0-d tensors on the operands' device: PyTorch turns a
division by a Python scalar on CUDA into a multiplication by its
reciprocal, which would not round as the kernel's IEEE division does.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float32, as a 0-d tensor on ``like``'s device. Made
    by a fill on the device: a copy from the host would wait for the
    device's queue to drain."""
    return torch.full((), f32(x), dtype=torch.float32, device=like.device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of ``x`` on every device, as XLA's
    and CUDA's roots are. The CPU's float32 ``torch.sqrt`` is not (one ulp
    off on some inputs), so a float32 root off the card is taken in
    float64 and rounded once: a float64 root of a float32 value rounds to
    the correctly rounded float32 root (53 ≥ 2·24 + 2 bits)."""
    if x.dtype != torch.float32 or x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _adamw_f32(w, g, m, v, *, lr, b1, b2, eps, weight_decay, c1, c2):
    """The f32 maths shared by both AdamW steps: (w_new, m_new, v_new)
    from f32 (w, g, m, v), in the order of ``_adamw_kernel``
    (src/repro/kernels/fused_adamw.py): the JAX oracle squares g first,
    the kernel multiplies (1-b2)*g by g."""
    c1t, c2t = device_scalar(c1, w), device_scalar(c2, w)
    m_new = f32(b1) * m + f32(1.0 - b1) * g
    v_new = f32(b2) * v + f32(1.0 - b2) * g * g
    step = (m_new / c1t) / (sqrt_rn(v_new / c2t) + f32(eps)) \
        + f32(weight_decay) * w
    return w - f32(lr) * step, m_new, v_new


def fused_adamw(p, g, m, v, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.1, c1=1.0, c2=1.0):
    """One AdamW step on one tensor; returns new (p, m, v). The maths runs
    in float32 whatever the storage dtype (float32 or bfloat16), and each
    output is rounded to its operand's dtype (to nearest, ties to even)."""
    p_new, m_new, v_new = _adamw_f32(
        p.float(), g.float(), m.float(), v.float(), lr=lr, b1=b1, b2=b2,
        eps=eps, weight_decay=weight_decay, c1=c1, c2=c2)
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def fused_adamw_mixed(g, m, v, master, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.1, c1=1.0, c2=1.0,
                      param_dtype=torch.bfloat16):
    """One mixed-precision AdamW step on one tensor, the maths of
    ``_adamw_mixed_kernel``: the master (float32) is the authoritative
    parameter, g, m and v ride at the replica dtype (bfloat16), all maths
    is float32. Returns (p_working at ``param_dtype``, m_new, v_new,
    master_new), each rounded to its dtype."""
    w_new, m_new, v_new = _adamw_f32(
        master.float(), g.float(), m.float(), v.float(), lr=lr, b1=b1,
        b2=b2, eps=eps, weight_decay=weight_decay, c1=c1, c2=c2)
    return (w_new.to(param_dtype), m_new.to(m.dtype), v_new.to(v.dtype),
            w_new.to(master.dtype))


def outer_nesterov(p, delta, buf, *, lr, momentum=0.9):
    """θ ← θ − lr·(μ·b_new + Δ) with b_new = μ·b + Δ. Returns (p, buf)."""
    mu = f32(momentum)
    b_new = mu * buf + delta
    p_new = p - f32(lr) * (mu * b_new + delta)
    return p_new, b_new


# ---------------------------------------------------------------------------
# per-neuron sign pruning of outer gradients
# ---------------------------------------------------------------------------

PRUNE_ITERS = 26
# hi0 = max|x| * HI_SCALE + HI_FLOOR, the JAX constants rounded to float32
HI_SCALE, HI_FLOOR = f32(1.0 + 1e-6), f32(1e-30)


def keep_count(frac: float, cols: int) -> int:
    """Entries kept per row of ``cols``: max(round((1 - frac)·cols), 1),
    with Python's round (half to even), as the JAX wrapper computes it."""
    return max(int(round((1.0 - frac) * cols)), 1)


def bisect_threshold(mag, keep: int, iters: int = PRUNE_ITERS):
    """Per-row threshold t with count(mag >= t) <= keep, by ``iters`` fixed
    bisection steps from [0, max·(1 + 1e-6) + 1e-30]. mag: (R, C) >= 0,
    float32. Returns hi (R, 1)."""
    lo = torch.zeros((mag.shape[0], 1), dtype=torch.float32,
                     device=mag.device)
    hi = mag.amax(dim=-1, keepdim=True) * HI_SCALE + HI_FLOOR
    for _ in range(iters):
        mid = f32(0.5) * (lo + hi)
        too_many = (mag >= mid).sum(dim=-1, keepdim=True) > keep
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    return hi


def sign_prune_parts(x, frac: float):
    """(elected sign (R, 1), threshold (R, 1), pruned x) of
    ``sign_prune``: the per-row quantities the kernel is held to."""
    xf = x.float()
    mag = xf.abs()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    pos = torch.where(xf > 0, mag, zero).sum(dim=-1, keepdim=True)
    neg = torch.where(xf < 0, mag, zero).sum(dim=-1, keepdim=True)
    elected = torch.where(pos >= neg, 1.0, -1.0)
    # sign(0) = 0 agrees with neither elected sign
    agrees = torch.sign(xf) == elected
    hi = bisect_threshold(mag, keep_count(frac, x.shape[-1]))
    keep = agrees & (mag >= hi)
    return elected, hi, torch.where(keep, x, torch.zeros_like(x))


def sign_prune(x, frac: float):
    """x: (R, C). Per row: elect the sign with the larger magnitude mass
    (ties to +), keep the entries that agree with it and lie in the top
    (1 - frac) by magnitude (threshold by fixed bisection), zero the
    rest. The JAX ``ref.sign_prune``."""
    return sign_prune_parts(x, frac)[2]


# ---------------------------------------------------------------------------
# low-precision outer-gradient transport (streaming DiLoCo)
# ---------------------------------------------------------------------------

INT4_LEVELS = 7.0          # symmetric int4: codes in [-7, 7]
# scale = amax × this pre-rounded float32 constant (not amax / 7), as in
# the JAX reference, so every implementation rounds the scale alike
INV_INT4_LEVELS = float(np.float32(1.0 / INT4_LEVELS))
QUANT_BLOCK = 128          # elements sharing one int4 scale


def _codes_int8(q):
    """Integral float32 codes in [-7, 7] (NaN where the block is NaN) ->
    int8. A NaN becomes code 0, as JAX's float -> int cast makes it;
    PyTorch's cast of a NaN is undefined, so it is written out."""
    return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(
        torch.int8)


def quantize_int4(x):
    """Blockwise symmetric int4 quantization. x: (R, C), each row a block
    sharing one float32 scale. Returns (codes int8 in [-7, 7], scales
    (R, 1) float32); an all-zero block gets scale 0 and codes 0."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) * INV_INT4_LEVELS
    q = torch.round(xf / torch.where(scale > 0, scale,
                                     torch.ones_like(scale)))
    return _codes_int8(q.clamp(-INT4_LEVELS, INT4_LEVELS)), scale


def dequantize_int4(codes, scales):
    """Inverse of ``quantize_int4``: (R, C) int8 × (R, 1) float32."""
    return codes.float() * scales


def fake_quant(x, dtype: str):
    """Quantize→dequantize round trip at the transport ``dtype``. int4: x
    is (R, C) blocks, one scale per row; bfloat16: any shape. Returns x's
    shape and dtype.

    int4 is computed as the Pallas ``_fake_quant_kernel`` computes it, the
    codes kept in float32: ``dequantize_int4(quantize_int4(x))`` on finite
    blocks. A block holding a NaN or an infinity comes out all NaN, as in
    the JAX package: the max carries the NaN into the scale, an infinite
    scale gives 0·inf, and the clip lets a NaN through."""
    if dtype == "float32":
        return x
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).to(x.dtype)
    if dtype != "int4":
        raise ValueError(f"unknown transport dtype {dtype!r}")
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) * INV_INT4_LEVELS
    q = torch.round(xf / torch.where(scale > 0, scale,
                                     torch.ones_like(scale)))
    return (q.clamp(-INT4_LEVELS, INT4_LEVELS) * scale).to(x.dtype)


def fake_quant_rows(x, dtype: str):
    """``fake_quant`` of each row of a (rows, n) float32 matrix on its own:
    int4 blocks are 128 consecutive entries of a row, the last one padded
    with zeros (which change no block's max). Returns a new (rows, n)."""
    if dtype != "int4":
        return fake_quant(x, dtype)
    rows, n = x.shape
    nb = -(-n // QUANT_BLOCK)
    padded = torch.zeros((rows, nb * QUANT_BLOCK), dtype=x.dtype,
                         device=x.device)
    padded[:, :n] = x
    out = fake_quant(padded.view(rows * nb, QUANT_BLOCK), dtype)
    return out.view(rows, nb * QUANT_BLOCK)[:, :n].contiguous()


# ---------------------------------------------------------------------------
# packed int4 wire (the async transport's worker -> server payload)
# ---------------------------------------------------------------------------

# The packed int4 wire's code bytes are padded to this byte boundary, so
# that the float32 scales after them stay word-aligned.
WIRE_ALIGN = 4


def pack_int4(codes):
    """Nibble-pack int4 codes: flat (n,) int8 in [-7, 7] -> (ceil(n/2),)
    int8 wire bytes. Byte b holds element 2b in its low nibble and element
    2b+1 in its high nibble (4-bit two's complement); an odd tail pads one
    zero nibble. The JAX ``ref.pack_int4``."""
    n = codes.shape[0]
    if n % 2:
        codes = torch.cat([codes, codes.new_zeros(1)])
    c = codes.reshape(-1, 2).to(torch.int32) & 0xF
    return (c[:, 0] | (c[:, 1] << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed, n: int):
    """Inverse of ``pack_int4``: (ceil(n/2),) int8 wire bytes -> (n,) int8
    codes in [-7, 7] (4-bit two's complement sign extension)."""
    p = packed.view(torch.uint8).to(torch.int32)
    nib = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(-1)[:n]
    return ((nib ^ 8) - 8).to(torch.int8)


def quantize_pack_int4(x):
    """The fused sender's maths: (R, 128) float32 blocks -> (packed (R, 64)
    int8 wire bytes, scales (R, 1) float32, local (R, 128) float32), the
    JAX ``ref.quantize_pack_int4`` (``quantize_int4`` -> ``pack_int4`` ->
    ``dequantize_int4``) with the kernel's local: ``clip(q)·scale`` from
    the float codes, which keeps the sign of a −0.0 and is otherwise the
    dequantized int8 codes' value (NaN where the block is NaN or
    infinite)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) * INV_INT4_LEVELS
    q = torch.round(xf / torch.where(scale > 0, scale,
                                     torch.ones_like(scale)))
    q = q.clamp(-INT4_LEVELS, INT4_LEVELS)
    rows, cols = x.shape
    packed = pack_int4(_codes_int8(q).reshape(-1)).reshape(rows, cols // 2)
    return packed, scale, q * scale


def unpack_dequantize_int4(packed, scales):
    """The fused receiver's maths: (R, 64) int8 wire bytes × (R, 1) float32
    scales -> (R, 128) float32, the JAX ``ref.unpack_dequantize_int4``
    (``unpack_int4`` -> ``dequantize_int4``)."""
    rows, cols = packed.shape
    codes = unpack_int4(packed.reshape(-1), rows * cols * 2).reshape(
        rows, cols * 2)
    return dequantize_int4(codes, scales)


def weighted_sum(vals, m):
    """sum_j m[j] * vals[j] over the leading replica dim, in replica
    order: acc = m[0]·vals[0], then acc + m[j]·vals[j], each product and
    sum rounded to float32. The order every reduce over replicas of the
    port takes (the kernel of ``unpack_dequantize_reduce`` too), so the
    paths agree bit for bit. A zero ``m[j]`` still multiplies: a NaN or
    an infinity in ``vals[j]`` poisons the sum, as in the JAX reduce."""
    acc = m[0] * vals[0]
    for j in range(1, vals.shape[0]):
        acc = acc + m[j] * vals[j]
    return acc


def unpack_dequantize_reduce(packed, scales, m):
    """The fused deferred consumer's maths: packed (k, R, 64) int8 wire
    bytes, scales (k, R, 1) float32 and the mask m (k,) float32 -> the
    (R, 128) float32 masked sum Σ_k m_k · codes_k · scale_k (the caller
    divides by the mask sum), the JAX ``ref.unpack_dequantize_reduce``
    summed in replica order (``weighted_sum``)."""
    vals = torch.stack([unpack_dequantize_int4(p, s)
                        for p, s in zip(packed, scales)])
    return weighted_sum(vals, m.float())


def wire_sections(n: int):
    """(code bytes, zero padding, blocks) of the packed int4 wire of ``n``
    entries: ceil(n/2) code bytes, padding to ``WIRE_ALIGN``, then one
    float32 scale per started 128-entry block."""
    cb = -(-n // 2)
    return cb, (-cb) % WIRE_ALIGN, -(-n // QUANT_BLOCK)


def wire_encode_int4(x):
    """Flat float32 (n,) -> (wire, local): ``quantize_pack_int4`` over the
    zero-padded 128-entry blocks, laid out as ONE uint8 buffer (the
    ``cb`` code bytes, zero padding, the scales' bytes), and the (n,)
    local values. Codes past n quantize to 0, so an odd n's last byte has
    a zero high nibble."""
    n = x.shape[0]
    cb, pad, rows = wire_sections(n)
    blocks = torch.zeros((rows * QUANT_BLOCK,), dtype=torch.float32,
                         device=x.device)
    blocks[:n] = x
    packed, scales, local = quantize_pack_int4(
        blocks.view(rows, QUANT_BLOCK))
    wire = torch.zeros((cb + pad + 4 * rows,), dtype=torch.uint8,
                       device=x.device)
    wire[:cb] = packed.reshape(-1)[:cb].view(torch.uint8)
    wire[cb + pad:] = scales.reshape(-1).view(torch.uint8)
    return wire, local.reshape(-1)[:n]


def wire_decode_int4(wire, n: int):
    """The packed int4 wire of ``n`` entries -> (n,) float32:
    ``unpack_dequantize_int4`` over the code bytes padded with zero codes
    to whole blocks."""
    cb, pad, rows = wire_sections(n)
    codes = torch.zeros((rows * QUANT_BLOCK // 2,), dtype=torch.uint8,
                        device=wire.device)
    codes[:cb] = wire[:cb]
    scales = wire[cb + pad:cb + pad + 4 * rows].clone().view(
        torch.float32).reshape(rows, 1)
    vals = unpack_dequantize_int4(
        codes.view(torch.int8).reshape(rows, QUANT_BLOCK // 2), scales)
    return vals.reshape(-1)[:n]


def wire_reduce_int4(gathered, n: int, m):
    """The k packed int4 wires of one region of ``n`` entries, gathered
    as the rows of ``gathered`` (k, W) uint8, decoded and summed weighted
    by ``m`` (k,): ``unpack_dequantize_reduce`` over the code bytes padded
    with zero codes to whole blocks (as the JAX ``ops.wire_reduce`` pads
    them). Returns (n,) float32."""
    k = gathered.shape[0]
    cb, pad, rows = wire_sections(n)
    codes = torch.zeros((k, rows * QUANT_BLOCK // 2), dtype=torch.uint8,
                        device=gathered.device)
    codes[:, :cb] = gathered[:, :cb]
    scales = gathered[:, cb + pad:cb + pad + 4 * rows].contiguous().view(
        torch.float32).reshape(k, rows, 1)
    red = unpack_dequantize_reduce(
        codes.view(torch.int8).reshape(k, rows, QUANT_BLOCK // 2), scales, m)
    return red.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, d); k/v: (B, Sk, G, d), H % G == 0: the JAX
    ``kernels/ref.py`` full-softmax attention, in the model layout. Masks
    use the ``(Sk - Sq)`` offset of that reference."""
    B, Sq, H, d = q.shape
    _, Sk, G, _ = k.shape
    rep = H // G
    scale = d ** -0.5 if scale is None else scale
    qh = (q * f32(scale)).reshape(B, Sq, G, rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qh, k.float())
    # queries start at Sk - Sq here whether or not the mask is causal
    ok = flash_visible(Sq, Sk, causal=causal, window=window,
                       q_offset=0 if causal else Sk - Sq, device=q.device)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(B, Sq, H, d).to(q.dtype)


def flash_visible(Sq, Sk, *, causal, window, q_offset=0, device=None):
    """(Sq, Sk) bool: which keys each query sees, from absolute positions
    with the kernels' rule: queries start at q_offset + (Sk - Sq) when
    causal and Sq != Sk, else at q_offset."""
    off = q_offset + (Sk - Sq if causal and Sq != Sk else 0)
    qpos = torch.arange(Sq, device=device)[:, None] + off
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window and window > 0:
        ok = ok & (kpos > qpos - window)
    return ok


def _per_query_head(t, rep, dtype=torch.float32):
    """(B, G, S, d) -> (B, G * rep, S, d): query head h reads kv head
    h // rep."""
    return t.repeat_interleave(rep, dim=1).to(dtype)


def flash_fwd_lse(q, k, v, *, causal=True, window=0, scale=None,
                  q_offset=0):
    """The forward kernels' maths in the kernel layout: q (B, H, Sq, d),
    k/v (B, G, Sk, d). Returns o (B, H, Sq, d) as q.dtype and the per-row
    logsumexp lse = m + log(max(l, 1e-30)) (B, H, Sq) float32. Float64
    inputs are computed in float64 (lse too): the kernels' tests take it
    as the truth where float32's own rounding nears their tolerance."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    ok = flash_visible(Sq, Sk, causal=causal, window=window,
                       q_offset=q_offset, device=q.device)
    s = (q.to(dt) * f32(scale)) @ _per_query_head(k, H // G, dt).transpose(
        -1, -2)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    o = (p @ _per_query_head(v, H // G, dt)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _flash_p_ds(q, k, v, lse, do, delta, ok, scale):
    """Per query head: q·scale, k, p recomputed from lse and
    dS = p∘(dO·vᵀ − Δ)."""
    rep = q.shape[1] // k.shape[1]
    qs = q.float() * f32(scale)
    kh = _per_query_head(k, rep)
    p = torch.where(ok, torch.exp(qs @ kh.transpose(-1, -2)
                                  - lse.float()[..., None]), 0.0)
    ds = p * (do.float() @ _per_query_head(v, rep).transpose(-1, -2)
              - delta.float()[..., None])
    return qs, kh, p, ds


def flash_bwd_dq(q, k, v, lse, do, delta, *, causal=True, window=0,
                 scale=None, q_offset=0):
    """The dq kernel's maths: dq = (dS·k)·scale."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    ok = flash_visible(q.shape[2], k.shape[2], causal=causal, window=window,
                       q_offset=q_offset, device=q.device)
    _, kh, _, ds = _flash_p_ds(q, k, v, lse, do, delta, ok, scale)
    return ((ds @ kh) * f32(scale)).to(q.dtype)


def flash_bwd_dkv(q, k, v, lse, do, delta, *, causal=True, window=0,
                  scale=None, q_offset=0):
    """The dk/dv kernel's maths: dk = dSᵀ·(q·scale) and dv = pᵀ·dO per
    query head, summed over each GQA group."""
    B, H, Sq, d = q.shape
    G, Sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    ok = flash_visible(Sq, Sk, causal=causal, window=window,
                       q_offset=q_offset, device=q.device)
    qs, _, p, ds = _flash_p_ds(q, k, v, lse, do, delta, ok, scale)
    dk = (ds.transpose(-1, -2) @ qs).view(B, G, H // G, Sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ do.float()).view(B, G, H // G, Sk, d).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, o, lse, do, *, causal=True, window=0, scale=None,
              q_offset=0):
    """The backward kernels' maths in the kernel layout: Δ = rowsum(dO∘O),
    then ``flash_bwd_dq`` and ``flash_bwd_dkv``. Returns (dq, dk, dv) as
    q, k, v's dtypes."""
    delta = (do.float() * o.float()).sum(-1)
    opts = dict(causal=causal, window=window, scale=scale,
                q_offset=q_offset)
    return (flash_bwd_dq(q, k, v, lse, do, delta, **opts),
            *flash_bwd_dkv(q, k, v, lse, do, delta, **opts))

