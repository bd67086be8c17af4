"""Exact global FLOPs and modelled memory traffic of a PyTorch function,
counted at the ATen dispatch (the JAX ``launch/jaxpr_cost.py``).

``op_cost(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode``, on
meta tensors at full size (``torch.device("meta")``: shapes and dtypes, no
storage, nothing computed), and counts every ATen op that
reaches the dispatcher: the forward, the autograd backward, and the
recompute of ``torch.utils.checkpoint`` as it runs. Python loops run
unrolled, so trip counts are exact by construction (a layer loop of 64
counts 64 layers). Where a loop runs once per token (the xLSTM cells), the
caller counts at four short lengths and extrapolates
(``launch/dryrun.py``); nothing here multiplies.

  * ``flops``     — 2·M·N·K for every matmul-class op (``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, ``mv``, ``dot``; ``einsum``, ``matmul`` and
    ``linear`` decompose into them before they dispatch), plus the
    per-element FLOPs of the fused leaves below. Elementwise ops count no
    FLOPs, as in the JAX counter.
  * ``bytes``     — upper bound: every op's outputs, plus the operands of
    the matmul and gather/scatter/index ops. View ops (which write
    nothing) and the uninitialised factories (``empty``) count nothing.
  * ``bytes_min`` — fused lower bound: only the matmul and gather-class
    I/O and the fused leaves' I/O; elementwise chains are free, as if
    fused into their neighbours.
  * ``dots``      — the number of matmul-class ops.

The fused-leaf rule: a call into one of the port's kernel wrappers (the
flash forward and backward, ``fused_adamw*``, ``outer_nesterov``,
``sign_prune``, the quantize codecs) counts as ONE op that reads its
operands once and writes its results once, with the per-element FLOPs
that PERF.md §6 gives each kernel; its outputs are left uninitialised.
A stand-in launches nothing and computes nothing, so it refuses a tensor
that is not on the meta device (a count on real tensors would hand back
garbage and leave the kernels' launch counters at 0). This plays the part of JAX's "an innermost scan is one fused kernel", and
it keeps plain code that needs values (a bisection, a data-dependent
loop) off the meta tensors. The flash leaves count the (query, key) pairs
their mask lets through, as the kernels skip the rest.

Memory: each op's fresh outputs are tracked by their storage until the
storage is freed; ``peak_live_bytes`` is the peak of that live set during
the run (what the function allocates beyond its arguments) and
``end_live_bytes`` what is still live when it returns (its results
among it).

On an island's DTensors (``sharding/spec.py``; meta blocks on a process
group of the mesh's size) the counter sees each DTensor op at its global
shapes, and counts its FLOPs and bytes there: the totals stay global, and
equal those of the same function on plain tensors. It runs the op under a
second mode that sees what DTensor does with this rank's blocks: their
storage is what is tracked as live (the memory of one chip, temporaries
such as a gathered weight included), and the functional collectives among
them are recorded in ``collectives`` (op, bytes a chip moves over its
links: an all-gather receives (n−1)/n of its result, a reduce-scatter
sends (n−1)/n of its input, an all-reduce or all-to-all (n−1)/n of its
tensor each way). Plain ops outside a DTensor op (a ``redistribute``'s, a
``to_local``'s, the model's own replicated index tensors) count once at
their shapes, and their collectives are recorded too. A fused leaf handed
DTensors counts the global leaf once (its FLOPs and bytes at the global
shape), as the kernel runs on every rank's block of it.
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..sharding.spec import BLOCKS
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default, aten.mv.default, aten.dot.default,
           aten.mm.dtype, aten.bmm.dtype}
_GATHER = {aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
           aten._index_put_impl_.default, aten.index_select.default,
           aten.index_add.default, aten.index_add_.default,
           aten.index_copy.default, aten.index_copy_.default,
           aten.gather.default, aten.scatter.src, aten.scatter.value,
           aten.scatter_.src, aten.scatter_.value, aten.scatter_add.default,
           aten.scatter_add_.default, aten.embedding.default,
           aten.embedding_dense_backward.default}
_NO_WRITE = {aten.empty.memory_format, aten.empty_strided.default,
             aten.new_empty.default, aten.new_empty_strided.default,
             aten.empty_like.default}

# Per-element FLOPs of each kernel (``kernels/csrc``; the counts PERF.md
# §6's bounds and ``chip_smoke.py`` use): AdamW 16; Nesterov 6;
# sign_prune at most 60 (a warp row's |x|, two selects and adds and the
# max, 26 bisection steps of a compare and an add, the mask; a long row's
# entry takes fewer); fake_quant int4 7 (|x|, the max, the divide, rint,
# the clip's two compares, the multiply; the scale's one multiply a block
# is not counted), bf16 1 (the rounding); the packed wire's sender 8 (|x|,
# max, divide, rint, the clip's two compares, the NaN test, the shift-or)
# and receiver 4 (shift, mask, sign extension, multiply); the reduce 6 per
# entry and replica (shift and mask, sign extension, the scale's and the
# mask's multiplies, the add); the unfused codecs 8 (quantize, as the
# sender), 2 (dequantize: conversion and multiply), 2 (pack a code: mask
# and shift-or), 4 (unpack a code: shift, mask, sign extension).
# A flash kernel does 2·d FLOPs per visible (query, key) pair and head for
# each product it computes: 2 forward, 3 in dq, 4 in dk/dv.
LEAF_FLOPS = {"fused_adamw": 16, "fused_adamw_bf16": 16,
              "fused_adamw_mixed": 16, "outer_nesterov": 6,
              "sign_prune": 60, "fake_quant_int4": 7, "fake_quant_bf16": 1,
              "quantize_pack_int4": 8, "unpack_dequantize_int4": 4,
              "unpack_dequantize_reduce": 6, "quantize_int4": 8,
              "dequantize_int4": 2, "pack_int4": 2, "unpack_int4": 4,
              "flash_fwd": 4, "flash_fwd_lse": 4, "flash_bwd_dq": 6,
              "flash_bwd_dkv": 8}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _blocks(tensors) -> int:
    """The island blocks the plain tensors stand for (1 unmarked)."""
    return max((getattr(t, BLOCKS, 1) for t in tensors), default=1)


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _is_fake_type(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return issubclass(t, FakeTensor)


def _group_size(name) -> int:
    """The size of a process group given by its name (or itself)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_world_size(_resolve_process_group(name)
                               if isinstance(name, str) else name)



def _is_collective(func) -> bool:
    """A functional collective, or DTensor's all-to-all between two shard
    dims of one mesh axis (``_dtensor.shard_dim_alltoall``)."""
    return func.namespace == "_c10d_functional" or (
        func.namespace == "_dtensor"
        and func.__name__.startswith("shard_dim_alltoall"))


def _collective(func, args) -> tuple | None:
    """(op, bytes a chip moves) of a functional collective, else None."""
    if not _is_collective(func):
        return None
    name = func.__name__.split(".")[0]
    if name == "shard_dim_alltoall":
        n = _group_size(args[3])
        return "all-to-all", _nbytes(args[0]) * (n - 1) // n
    if name == "all_gather_into_tensor":
        t, n = args[0], int(args[1])
        return "all-gather", _nbytes(t) * (n - 1)
    if name == "reduce_scatter_tensor":
        t, n = args[0], int(args[2])
        return "reduce-scatter", _nbytes(t) * (n - 1) // n
    if name in ("all_reduce", "all_reduce_"):
        n = _group_size(args[2])
        return "all-reduce", _nbytes(args[0]) * (n - 1) // n
    if name == "all_to_all_single":
        n = _group_size(args[3])
        return "all-to-all", _nbytes(args[0]) * (n - 1) // n
    if name == "broadcast":
        return "collective-broadcast", _nbytes(args[0])
    if name.startswith(("all_", "reduce_", "broadcast", "scatter",
                        "gather")):
        raise NotImplementedError(f"op_cost: collective {func} is not "
                                  "counted")
    return None        # wait_tensor and the autograd wrappers move nothing


class _LocalOps(TorchDispatchMode):
    """The ops a DTensor op runs on this rank's blocks: the counter tracks
    their fresh storage and records their collectives, and counts nothing
    else (the DTensor op is counted at its global shapes)."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented      # DTensor desugars it into local ops
        out = func(*args, **(kwargs or {}))
        if any(_is_fake_type(t) for t in types) or any(
                _is_fake_type(type(t)) for t in _tensors(out)):
            return out    # DTensor's shape propagation on fake global tensors
        self.counter._fresh(func, out)
        self.counter._communicate(func, args)
        return out


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _matmul_flops(func, args, out) -> int:
    if func in (aten.addmm.default, aten.baddbmm.default):
        args = args[1:]                    # (bias, a, b)
    a = args[0]
    return 2 * out.numel() * a.shape[-1] if a.dim() else 2


class OpCounter(TorchDispatchMode):
    """The counting mode (see the module's doc). ``leaf`` records one
    fused kernel call; ``leaves`` counts them by name."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.bytes_min = self.dots = 0
        self.leaves: dict = {}
        self.collectives: list = []          # (op, bytes) per chip
        self.live = self.peak = 0
        self._tracked: set = set()
        self._quiet = 0

    def _free(self, key, n):
        self._tracked.discard(key)
        self.live -= n

    def _track(self, t):
        s = t.untyped_storage()
        key = id(s)
        if key in self._tracked:
            return
        n = s.nbytes()
        self._tracked.add(key)
        weakref.finalize(s, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _fresh(self, func, out):
        """Track the storage of ``out``'s tensors that ``func`` made."""
        if func.is_view:
            return
        for t, r in zip(_tensors(out), func._schema.returns):
            if r.alias_info is None:
                self._track(t)

    def _communicate(self, func, args):
        got = _collective(func, args)
        if got is not None:
            self.collectives.append(got)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_fake_type(t) for t in types):
            return func(*args, **(kwargs or {}))     # shapes, not work
        sharded = any(_is_dtensor_type(t) for t in types)
        if sharded:
            # the blocks' storage and collectives, seen by the local mode
            with _LocalOps(self):
                out = func(*args, **(kwargs or {}))
        else:
            out = func(*args, **(kwargs or {}))
            self._fresh(func, out)
            self._communicate(func, args)
            if _is_collective(func):
                return out
        outs = _tensors(out)
        # a rank's block of work split over an island (``spec.mark_local``)
        # counts for every block; what is made from it is marked too
        blocks = 1 if sharded else _blocks(_tensors((args, kwargs)))
        if blocks > 1:
            for t in outs:
                setattr(t, BLOCKS, blocks)
        if self._quiet or func.is_view:
            return out
        out_b = sum(_nbytes(t) for t in outs) if func not in _NO_WRITE \
            else 0
        if func in _MATMUL:
            io = out_b + sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.flops += _matmul_flops(func, args, outs[0]) * blocks
            self.dots += 1
            self.bytes += io * blocks
            self.bytes_min += io * blocks
        elif func in _GATHER:
            io = out_b + sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += io * blocks
            self.bytes_min += io * blocks
        else:
            self.bytes += out_b * blocks
        return out

    def leaf(self, name: str, count: int, reads, writes):
        """One fused kernel call: ``reads`` read once, ``writes`` written
        once, ``LEAF_FLOPS[name]`` FLOPs for each of ``count`` elements
        (entries, entry-replicas, or visible pairs × heads × d). Every
        tensor must be on the meta device."""
        off_meta = sorted({str(t.device) for t in (*reads, *writes)
                           if t is not None and t.device.type != "meta"})
        if off_meta:
            raise RuntimeError(
                f"op_cost counts on meta tensors only: the stand-in for "
                f"{name} got a tensor on {', '.join(off_meta)} (it computes "
                "nothing and launches no kernel)")
        io = sum(_nbytes(t) for t in (*reads, *writes) if t is not None)
        blocks = _blocks([t for t in reads if t is not None])
        self.flops += LEAF_FLOPS[name] * int(count) * blocks
        self.bytes += io * blocks
        self.bytes_min += io * blocks
        self.leaves[name] = self.leaves.get(name, 0) + 1

    @contextlib.contextmanager
    def quiet(self):
        """Ops dispatched inside count nothing (a leaf making its outputs);
        their storage is still tracked."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_min": self.bytes_min, "dots": self.dots,
                "peak_live_bytes": self.peak, "end_live_bytes": self.live,
                "leaves": dict(self.leaves),
                "collectives": list(self.collectives)}


# ---------------------------------------------------------------------------
# fused leaves: stand-ins for the kernel wrappers while a counter runs
# ---------------------------------------------------------------------------

def visible_pairs(Sq: int, Sk: int, *, causal: bool, window: int,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the flash kernels' mask lets through
    (``ref.flash_visible``'s rule), counted on the host."""
    off = q_offset + (Sk - Sq if causal and Sq != Sk else 0)
    qpos = np.arange(Sq, dtype=np.int64) + off
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window and window > 0 \
        else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _stand_ins(c: OpCounter) -> dict:
    """{(module, function name): stand-in} for every kernel wrapper."""
    from ..kernels import flash_attention as FK
    from ..kernels import fused_adamw as FA
    from ..kernels import outer_nesterov as ON
    from ..kernels import quantize as QZ
    from ..kernels import sign_prune as SP

    def empty(*like):
        with c.quiet():
            return tuple(torch.empty_like(t) for t in like)

    def new(shape, dtype, like):
        with c.quiet():
            return torch.empty(shape, dtype=dtype, device=like.device)

    def adamw_name(p):
        return "fused_adamw_bf16" if p.dtype == torch.bfloat16 \
            else "fused_adamw"

    def adamw_(p, g, m, v, **_):
        c.leaf(adamw_name(p), p.numel(), (p, g, m, v), (p, m, v))

    def adamw(p, g, m, v, **_):
        outs = empty(p, m, v)
        c.leaf(adamw_name(p), p.numel(), (p, g, m, v), outs)
        return outs

    def adamw_mixed_(p, g, m, v, master, **_):
        c.leaf("fused_adamw_mixed", g.numel(), (g, m, v, master),
               (p, m, v, master))

    def adamw_mixed(g, m, v, master, **_):
        outs = empty(g, m, v, master)
        c.leaf("fused_adamw_mixed", g.numel(), (g, m, v, master), outs)
        return outs

    def nesterov_(p, delta, buf, **_):
        c.leaf("outer_nesterov", p.numel(), (p, delta, buf), (p, buf))

    def nesterov(p, delta, buf, **_):
        outs = empty(p, buf)
        c.leaf("outer_nesterov", p.numel(), (p, delta, buf), outs)
        return outs

    def prune_(x, frac):
        if frac > 0:
            c.leaf("sign_prune", x.numel(), (x,), (x,))
        return x

    def fake_quant(x, dtype, *, rows=1, out=None):
        if dtype == "float32":
            return x
        out = empty(x)[0] if out is None else out
        name = "fake_quant_int4" if dtype == "int4" else "fake_quant_bf16"
        c.leaf(name, x.numel(), (x,), (out,))
        return out

    def quantize_pack(x, wire, local=None):
        c.leaf("quantize_pack_int4", x.numel(), (x,), (wire, local))
        return wire

    def unpack_dequantize(wire, n, out=None):
        out = new((n,), torch.float32, wire) if out is None else out
        c.leaf("unpack_dequantize_int4", n, (wire,), (out,))
        return out

    def unpack_reduce(gathered, n, m, out=None):
        out = new((n,), torch.float32, gathered) if out is None else out
        c.leaf("unpack_dequantize_reduce", n * gathered.shape[0],
               (gathered, m), (out,))
        return out

    def quantize_int4(x):
        codes = new(x.shape, torch.int8, x)
        scales = new((x.shape[0], 1), torch.float32, x)
        c.leaf("quantize_int4", x.numel(), (x,), (codes, scales))
        return codes, scales

    def dequantize_int4(codes, scales):
        out = new(codes.shape, torch.float32, codes)
        c.leaf("dequantize_int4", codes.numel(), (codes, scales), (out,))
        return out

    def pack_int4(codes):
        out = new((codes.shape[0], codes.shape[1] // 2), torch.int8, codes)
        c.leaf("pack_int4", codes.numel(), (codes,), (out,))
        return out

    def unpack_int4(packed):
        out = new((packed.shape[0], packed.shape[1] * 2), torch.int8,
                  packed)
        c.leaf("unpack_int4", out.numel(), (packed,), (out,))
        return out

    def pairs_x_d(q, k, causal, window, q_offset):
        B, H, Sq, d = q.shape
        return B * H * d * visible_pairs(Sq, k.shape[2], causal=causal,
                                         window=window, q_offset=q_offset)

    def flash_fwd(q, k, v, *, causal=True, window=0, scale=None,
                  q_offset=0):
        o = empty(q)[0]
        c.leaf("flash_fwd", pairs_x_d(q, k, causal, window, q_offset),
               (q, k, v), (o,))
        return o

    def flash_fwd_lse(q, k, v, *, causal=True, window=0, scale=None,
                      q_offset=0):
        o = empty(q)[0]
        lse = new(q.shape[:3], torch.float32, q)
        c.leaf("flash_fwd_lse", pairs_x_d(q, k, causal, window, q_offset),
               (q, k, v), (o, lse))
        return o, lse

    def flash_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                  scale=None, q_offset=0):
        delta = (do.float() * o.float()).sum(-1)   # as there
        dq, dk, dv = empty(q, k, v)
        work = pairs_x_d(q, k, causal, window, q_offset)
        c.leaf("flash_bwd_dq", work, (q, k, v, do, lse, delta), (dq,))
        c.leaf("flash_bwd_dkv", work, (q, k, v, do, lse, delta),
               (dk, dv))
        return dq, dk, dv

    return {(FA, "fused_adamw_"): adamw_, (FA, "fused_adamw"): adamw,
            (FA, "fused_adamw_mixed_"): adamw_mixed_,
            (FA, "fused_adamw_mixed"): adamw_mixed,
            (ON, "outer_nesterov_"): nesterov_,
            (ON, "outer_nesterov"): nesterov,
            (SP, "sign_prune_"): prune_,
            (QZ, "fake_quant"): fake_quant,
            (QZ, "quantize_pack_int4"): quantize_pack,
            (QZ, "unpack_dequantize_int4"): unpack_dequantize,
            (QZ, "unpack_dequantize_reduce"): unpack_reduce,
            (QZ, "quantize_int4"): quantize_int4,
            (QZ, "dequantize_int4"): dequantize_int4,
            (QZ, "pack_int4"): pack_int4, (QZ, "unpack_int4"): unpack_int4,
            (FK, "flash_fwd"): flash_fwd, (FK, "flash_fwd_lse"): flash_fwd_lse,
            (FK, "flash_bwd"): flash_bwd}


@contextlib.contextmanager
def counting():
    """An active ``OpCounter`` with the fused-leaf stand-ins installed over
    the kernel wrappers; both are removed on exit."""
    c = OpCounter()
    swaps = _stand_ins(c)
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        with c:
            yield c
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def op_cost(fn, *args) -> dict:
    """Run ``fn(*args)`` on meta tensors and return its global
    {"flops", "bytes", "bytes_min", "dots"}, with ``peak_live_bytes``,
    ``end_live_bytes`` and the fused ``leaves`` by name."""
    with counting() as c:
        out = fn(*args)
        cost = c.result()
    del out
    return cost


class _CollectiveLog(TorchDispatchMode):
    """Records the functional collectives a run issues, DTensor's own
    among them (a DTensor op is let through to DTensor, whose local ops
    and collectives then come back here)."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        got = _collective(func, args)
        if got is not None:
            self.log.append(got)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def collective_log():
    """The list of (op, bytes a chip moves) of every functional collective
    issued while the context is active, on real tensors as the counter
    records them on meta ones: what a rank of an island measures of its
    own traffic."""
    log: list = []
    with _CollectiveLog(log):
        yield log

