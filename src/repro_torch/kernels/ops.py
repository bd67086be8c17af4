"""Backend dispatch for the port's kernels, and their tree-level forms.

``kernel_mode`` (TrainConfig / DiLoCoConfig):

  auto    the kernel wrapper: the CUDA kernel on CUDA tensors, its plain
          PyTorch version on CPU tensors (the default);
  kernel  the CUDA kernel, or an error on CPU tensors;
  ref     the plain PyTorch version, whatever the device.

The JAX package's ``pallas`` and ``interpret`` modes name TPU machinery
and have no counterpart here: they are rejected.

The tree-level updates and the pruning write their outputs over their
inputs (θ, m, v; θ, buffer; the outer deltas): the counterpart of the JAX
driver donating the state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import tree
from . import flash_attention as _flash
from . import fused_adamw as _adamw
from . import outer_nesterov as _nesterov
from . import quantize as _quant
from . import ref
from . import sign_prune as _prune

MODES = ("auto", "kernel", "ref")


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter in this process, by module:
    {"fused_adamw": {...}, "flash_attention": {...}, "outer_nesterov": n,
    "sign_prune": n, "quantize": {...}} (copies)."""
    return {"fused_adamw": dict(_adamw.launches),
            "flash_attention": dict(_flash.launches),
            "outer_nesterov": _nesterov.launches,
            "sign_prune": _prune.launches,
            "quantize": dict(_quant.launches)}


def _resolve(mode: str, like) -> bool:
    """-> use the kernel wrapper (True) or the plain version (False)."""
    if mode in ("pallas", "interpret"):
        raise ValueError(
            f"kernel_mode={mode!r} names TPU (Pallas) machinery, which the "
            "port has no counterpart of: use auto, kernel or ref")
    if mode not in MODES:
        raise ValueError(f"kernel_mode must be one of {MODES}, got {mode!r}")
    if mode == "kernel" and like.device.type != "cuda":
        raise ValueError("kernel_mode='kernel' launches the CUDA kernels and "
                         f"needs CUDA tensors, got {like.device}")
    return mode != "ref"


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    mode: str = "auto"):
    """Differentiable flash attention in the model layout: q (B, S, H, d),
    k/v (B, S, G, d) -> (B, S, H, d). ``auto`` and ``kernel`` go through
    the kernel wrapper (the kernels on CUDA tensors, the plain versions of
    their maths on CPU tensors); ``ref`` is the plain full-softmax
    attention of the JAX ``kernels/ref.py``."""
    if not _resolve(mode, q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    # the kernels read the (B, S, H, d) buffers in place through the
    # transposed views
    out = _flash.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window, scale=scale)
    return out.transpose(1, 2)


def adamw_scalars(count: int, b1: float, b2: float):
    """Bias corrections (c1, c2) = (1 − b1^t, 1 − b2^t) as float32, in the
    expressions of the JAX ``ops.adamw_update_tree``. ``count`` is the
    post-increment step, a host integer: no device sync."""
    cf = np.float32(count)
    one = np.float32(1.0)
    return one - np.float32(b1) ** cf, one - np.float32(b2) ** cf


def adamw_update_tree(params, grads, m, v, *, lr, count, b1=0.9, b2=0.95,
                      eps=1e-8, weight_decay=0.1, mode: str = "auto"):
    """One fused AdamW step over a whole tree, in place: the new params
    and moments are written over ``params``, ``m`` and ``v``, which are
    returned. ``count`` is the post-increment step. The leaves are all
    float32 or all bfloat16 (the pure-bf16 policy); the maths is float32
    either way."""
    c1, c2 = adamw_scalars(count, b1, b2)
    ps = tree.leaves(params)
    use_kernel = _resolve(mode, ps[0])
    for p, g, mm, vv in zip(ps, tree.leaves(grads), tree.leaves(m),
                            tree.leaves(v)):
        if use_kernel:
            _adamw.fused_adamw_(p, g, mm, vv, lr=lr, c1=c1, c2=c2, b1=b1,
                                b2=b2, eps=eps, weight_decay=weight_decay)
        else:
            outs = ref.fused_adamw(p, g, mm, vv, lr=lr, b1=b1, b2=b2,
                                   eps=eps, weight_decay=weight_decay,
                                   c1=c1, c2=c2)
            for dst, src in zip((p, mm, vv), outs):
                dst.copy_(src)
    return params, m, v


def adamw_update_tree_mixed(params, grads, m, v, master, *, lr, count,
                            b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                            mode: str = "auto"):
    """One mixed-precision fused AdamW step over a whole tree, in place:
    the float32 ``master`` is authoritative, ``grads``, ``m`` and ``v``
    ride at bfloat16, and the new bf16 working copy is written over
    ``params`` in the same pass. Returns (params, m, v, master)."""
    c1, c2 = adamw_scalars(count, b1, b2)
    ps = tree.leaves(params)
    use_kernel = _resolve(mode, ps[0])
    hp = dict(lr=lr, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    for p, g, mm, vv, w in zip(ps, tree.leaves(grads), tree.leaves(m),
                               tree.leaves(v), tree.leaves(master)):
        if use_kernel:
            _adamw.fused_adamw_mixed_(p, g, mm, vv, w, **hp)
        else:
            outs = ref.fused_adamw_mixed(g, mm, vv, w, param_dtype=p.dtype,
                                         **hp)
            for dst, src in zip((p, mm, vv, w), outs):
                dst.copy_(src)
    return params, m, v, master


def sign_prune(x, frac: float, *, mode: str = "auto"):
    """x: (R, C), pruned per row in place: the pruned values are written
    over ``x``, which is returned (``frac <= 0`` leaves it as it is)."""
    if frac <= 0:
        return x
    if _resolve(mode, x):
        return _prune.sign_prune_(x, frac)
    return x.copy_(ref.sign_prune(x, frac))


def as_rows(x, lead: int):
    """``x`` as (rows, cols): the first ``lead`` dims and the next one are
    rows, the rest columns; a leaf with no dim past ``lead`` is one row
    per leading index. None for a leaf with no dim beyond ``lead``'s."""
    if x.dim() <= lead:
        return None
    if x.dim() == lead + 1:
        return x.reshape(math.prod(x.shape[:lead]), x.shape[lead])
    return x.reshape(math.prod(x.shape[:lead + 1]), -1)


def sign_prune_tree(params, frac: float, *, mode: str = "auto",
                    stacked: bool = False):
    """Per-neuron sign pruning of every leaf, in place, as the JAX
    ``ops.sign_prune_tree``: each leaf is pruned as (leading dim, the rest
    flattened); a 1-D leaf is one row; a 0-d leaf is left as it is. The
    pruned values are written over the leaves (which must be contiguous),
    and ``params`` is returned.

    ``stacked=True``: every leaf carries a leading replica dim (k, ...) and
    each replica's leaf is pruned by that rule, with the k replicas' rows
    stacked into one (k·R, C) matrix: one pruning per leaf, the JAX
    ``vmap`` over k."""
    if frac <= 0:
        return params
    for x in tree.leaves(params):
        flat = as_rows(x, 1 if stacked else 0)
        if flat is None:
            continue
        if not x.is_contiguous():
            raise ValueError("in-place pruning needs contiguous leaves")
        sign_prune(flat, frac, mode=mode)
    return params


def nesterov_update_tree(params, delta, buf, *, lr, momentum=0.9,
                         mode: str = "auto"):
    """One fused outer Nesterov step over a whole tree, in place: the new
    θ and momentum buffer are written over ``params`` and ``buf``, which
    are returned."""
    ps = tree.leaves(params)
    use_kernel = _resolve(mode, ps[0])
    for p, d, b in zip(ps, tree.leaves(delta), tree.leaves(buf)):
        if use_kernel:
            _nesterov.outer_nesterov_(p, d, b, lr=lr, momentum=momentum)
        else:
            new_p, new_b = ref.outer_nesterov(p, d, b, lr=lr,
                                              momentum=momentum)
            p.copy_(new_p)
            b.copy_(new_b)
    return params, buf


# ---------------------------------------------------------------------------
# low-precision outer-gradient transport
# ---------------------------------------------------------------------------

# Wire cost of one transported element: int4 carries 0.5 B of codes plus
# one f32 scale per 128-element block (the large-tensor amortization;
# ``transport_bytes`` charges the started blocks exactly).
QUANT_BLOCK = ref.QUANT_BLOCK
# Packed int4 wire sections are padded to this byte boundary, so that the
# f32 scales after the nibble-packed codes stay word-aligned.
WIRE_ALIGN = ref.WIRE_ALIGN
TRANSPORT_BYTES_PER_ELEM = {
    "float32": 4.0,
    "bfloat16": 2.0,
    "int4": 0.5 + 4.0 / QUANT_BLOCK,
}


def quant_roundtrip(x, dtype: str, *, mode: str = "auto",
                    stacked: bool = False, out=None):
    """Simulated low-precision transport: the quantize→dequantize round
    trip of float32 ``x`` at ``dtype`` ("float32" returns ``x``). int4
    uses one f32 scale per 128 consecutive entries of the flattened
    tensor; ``stacked=True`` flattens each x[i] on its own (the JAX
    ``vmap`` over a leading replica dim), so no block spans two replicas.
    Writes into ``out`` when given (it may be ``x``)."""
    if dtype == "float32":
        return x
    if dtype not in TRANSPORT_BYTES_PER_ELEM:
        raise ValueError(f"unknown transport dtype {dtype!r}")
    rows = x.shape[0] if stacked else 1
    if _resolve(mode, x):
        return _quant.fake_quant(x, dtype, rows=rows, out=out)
    got = ref.fake_quant_rows(x.reshape(rows, -1), dtype).view(x.shape)
    return got if out is None else out.copy_(got)


def quant_roundtrip_tree(params, dtype: str, *, mode: str = "auto"):
    """``quant_roundtrip`` of every leaf (each leaf flattened whole)."""
    if dtype == "float32":
        return params
    return tree.map(lambda x: quant_roundtrip(x, dtype, mode=mode), params)


def transport_bytes(n_elems: int, dtype: str, *,
                    packed: bool = False) -> float:
    """Wire bytes for ``n_elems`` outer-gradient elements, as the JAX
    ``ops.transport_bytes``. ``packed=False`` (the fake-quant model): int4
    charges 0.5 B per element plus 4 B per started 128-element block.
    ``packed=True`` (the packed wire): int4 codes take ceil(n/2) bytes,
    padded to ``WIRE_ALIGN``, then 4 B per started block. float32 and
    bfloat16 ship whole elements either way."""
    if dtype not in TRANSPORT_BYTES_PER_ELEM:
        raise ValueError(f"unknown transport dtype {dtype!r}")
    if dtype == "int4":
        n = int(n_elems)
        blocks = -(-n // QUANT_BLOCK)
        if packed:
            code_bytes = -(-n // 2)
            code_bytes += (-code_bytes) % WIRE_ALIGN
            return float(code_bytes + 4 * blocks)
        return n * 0.5 + 4.0 * blocks
    return n_elems * TRANSPORT_BYTES_PER_ELEM[dtype]


def pack_int4(codes, *, mode: str = "auto"):
    """Nibble-pack flat (n,) int8 codes in [-7, 7] -> (ceil(n/2),) int8
    wire bytes, as the JAX ``ops.pack_int4``: under ``auto`` or ``kernel``
    the ``pack_int4`` kernel over the codes padded with zeros to whole
    128-entry blocks (its plain version on CPU tensors), under ``ref`` the
    plain version."""
    n = codes.shape[0]
    if not _resolve(mode, codes):
        return ref.pack_int4(codes)
    rows = -(-n // QUANT_BLOCK)
    padded = codes.new_zeros((rows * QUANT_BLOCK,))
    padded[:n] = codes
    out = _quant.pack_int4(padded.view(rows, QUANT_BLOCK))
    return out.reshape(-1)[:-(-n // 2)]


def unpack_int4(packed, n: int, *, mode: str = "auto"):
    """Inverse of ``pack_int4``: (ceil(n/2),) int8 bytes -> (n,) int8
    codes with 4-bit two's complement sign extension, as the JAX
    ``ops.unpack_int4`` (the ``unpack_int4`` kernel under ``auto`` or
    ``kernel``, over the bytes padded with zeros to whole blocks)."""
    if not _resolve(mode, packed):
        return ref.unpack_int4(packed, n)
    rows = -(-n // QUANT_BLOCK)
    half = QUANT_BLOCK // 2
    padded = packed.new_zeros((rows * half,))
    padded[:packed.shape[0]] = packed
    out = _quant.unpack_int4(padded.view(rows, half))
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# packed wire: one buffer per payload (the async transport's transfer, the
# sharded transport's gather)
# ---------------------------------------------------------------------------

def wire_dtype(dtype: str):
    """Element dtype of the wire buffer ``wire_encode`` builds: uint8 for
    int4, the bf16 bits as uint16 for bfloat16 (as in the JAX package)."""
    if dtype == "int4":
        return torch.uint8
    if dtype == "bfloat16":
        return torch.uint16
    raise ValueError(f"no packed wire for transport dtype {dtype!r}")


def wire_elems(n_elems: int, dtype: str) -> int:
    """Length of the wire buffer for ``n_elems`` entries, in elements of
    ``wire_dtype`` (for int4 exactly ``transport_bytes(n, 'int4',
    packed=True)`` bytes)."""
    if dtype == "int4":
        return int(transport_bytes(n_elems, dtype, packed=True))
    if dtype == "bfloat16":
        return int(n_elems)
    raise ValueError(f"no packed wire for transport dtype {dtype!r}")


def wire_encode(x, dtype: str, *, mode: str = "auto",
                with_local: bool = True):
    """Encode one flat float32 (n,) payload for the packed wire, as the
    JAX ``ops.wire_encode``. Returns ``(wire, local)``: ``wire`` is what
    the transfer ships (bf16: the bf16 bits as uint16; int4: ONE uint8
    buffer of ceil(n/2) nibble-packed code bytes, zero padding to
    ``WIRE_ALIGN`` and the per-128-block float32 scales' bytes), ``local``
    the sender's value of its payload (None with ``with_local=False``,
    which spares the int4 kernel writing it). int4 under ``auto`` or
    ``kernel`` runs the ``quantize_pack_int4`` kernel (its plain version
    on CPU tensors), under ``ref`` the plain version."""
    if dtype == "bfloat16":
        w = x.reshape(-1).to(torch.bfloat16)
        return w.view(torch.uint16), (w.float() if with_local else None)
    if dtype != "int4":
        raise ValueError(f"no packed wire for transport dtype {dtype!r}")
    flat = x.reshape(-1)
    if not _resolve(mode, flat):
        wire, local = ref.wire_encode_int4(flat.float())
        return wire, (local if with_local else None)
    wire = torch.empty((wire_elems(flat.numel(), dtype),),
                       dtype=torch.uint8, device=flat.device)
    local = torch.empty_like(flat) if with_local else None
    _quant.quantize_pack_int4(flat, wire, local)
    return wire, local


def wire_decode(wire, n_elems: int, dtype: str, *, mode: str = "auto",
                out=None):
    """Decode one payload's wire back to (n,) float32, as the JAX
    ``ops.wire_decode``: the value the sender's ``wire_encode`` reported
    as ``local`` (up to the sign of a zero: code 0 decodes to +0.0).
    int4 under ``auto`` or ``kernel`` runs the ``unpack_dequantize_int4``
    kernel (its plain version on CPU tensors); writes into ``out`` when
    given."""
    if dtype == "bfloat16":
        got = wire.view(torch.bfloat16).float()
        return got if out is None else out.copy_(got)
    if dtype != "int4":
        raise ValueError(f"no packed wire for transport dtype {dtype!r}")
    n = int(n_elems)
    if not _resolve(mode, wire):
        got = ref.wire_decode_int4(wire, n)
        return got if out is None else out.copy_(got)
    return _quant.unpack_dequantize_int4(wire, n, out)


def wire_reduce(gathered, n_elems: int, dtype: str, m, denom, *,
                mode: str = "auto"):
    """Consume one region's GATHERED wire, as the JAX ``ops.wire_reduce``:
    decode every replica's buffer and mask-reduce to the transported mean.
    gathered: (k, W) wire buffers in replica order (a column slice of a
    larger gathered buffer is read in place); m: (k,) float32 mask on the
    wire's device; denom: the mask sum. int4 under ``auto`` or ``kernel``
    makes ONE launch of the ``unpack_dequantize_reduce`` kernel (its plain
    version on CPU tensors), then divides by ``denom``. Every other case
    decodes each replica with ``wire_decode`` and sums them weighted by
    ``m`` in the kernel's order (``ref.weighted_sum``, the JAX tensordot's
    role), so the two agree bit for bit. Returns (n,) float32."""
    n = int(n_elems)
    if dtype == "int4" and _resolve(mode, gathered):
        return _quant.unpack_dequantize_reduce(gathered, n, m) / denom
    vals = torch.stack([wire_decode(w, n, dtype, mode=mode)
                        for w in gathered])
    return ref.weighted_sum(vals, m) / denom
