"""Parameters and DiLoCo state to and from numpy trees.

The port cannot reproduce ``jax.random``, so parity runs start from
parameters (or a whole state) made on the JAX side and handed over as
numpy arrays (``jax.tree.map(np.asarray, tree)``): nested dicts with the
same key paths and shapes. The state functions read and write the
fields of the JAX ``DiLoCoState`` (and of the streaming ``StreamState``
and the gossip ``GossipState``) by name, so every leaf can be compared; an async engine's state crosses
in the ``state_to_tree`` layout of the JAX ``core/async_diloco.py``.

On the sharded transport (``core/pod_collectives.py``) the port's state
holds one rank's replica band: ``sharded_state_from_numpy`` bands a full
JAX sharded ``StreamState`` for a rank, ``pod_collectives.
gather_stream_state`` gathers the bands back into one full state on rank
0, and ``stream_state_to_numpy`` writes that out. A packed in-flight
wire, (k, W) bytes, is written out decoded, as the per-leaf band payloads
of the other transports, so that two runs are compared by value.

numpy has no bfloat16 of its own (JAX hands its bf16 leaves over with
ml_dtypes' ``bfloat16``, which the port does not import). So bf16 leaves
cross as their bit patterns: a numpy leaf of dtype ``bfloat16`` (by name)
or ``uint16`` becomes a torch bfloat16 tensor of the same bits, and a
torch bfloat16 tensor becomes a ``uint16`` array (``bf16_to_f32`` widens
such bits to float32 exactly).
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree
from .core import async_diloco, gossip, pod_collectives, streaming
from .core.diloco import DiLoCoState
from .core.outer_opt import OuterState
from .kernels import ops
from .optim.adamw import AdamWState


def _is_bf16_bits(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or a.dtype == np.uint16


def tensor_from_numpy(a, *, device) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device`` (a copy); bfloat16 or
    uint16 arrays -> bfloat16 tensors of the same bits."""
    a = np.asarray(a)
    if _is_bf16_bits(a):
        bits = torch.from_numpy(np.array(a).view(np.int16))    # a copy
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; bfloat16 -> its uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 bit patterns -> float32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def params_from_numpy(params, *, device):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (copies; float32, or bfloat16 from bf16 bits)."""
    return tree.map(lambda a: tensor_from_numpy(a, device=device), params)


def params_to_numpy(params):
    return tree.map(tensor_to_numpy, params)


def state_from_numpy(state, *, device) -> DiLoCoState:
    """A JAX ``DiLoCoState`` whose leaves are numpy arrays -> the port's
    state on ``device``: bf16 replicas and moments, and the master copies
    of a mixed policy, are carried over."""
    to = lambda t: params_from_numpy(t, device=device)
    os_, is_ = state.outer_state, state.inner_state
    return DiLoCoState(
        global_params=to(state.global_params),
        outer_state=OuterState(to(os_.buf), to(os_.buf2), int(os_.count)),
        replica_params=to(state.replica_params),
        inner_state=AdamWState(
            to(is_.m), to(is_.v), np.asarray(is_.count, np.int32),
            None if is_.master is None else to(is_.master)),
        outer_t=int(state.outer_t),
        inner_steps_done=int(state.inner_steps_done))


def state_to_numpy(state: DiLoCoState) -> dict:
    """The port's state -> a nested dict of numpy arrays keyed like the
    JAX ``DiLoCoState`` fields (counters as int32 arrays; bf16 leaves as
    uint16 bits; ``inner_state.master`` only when the state has one)."""
    os_, is_ = state.outer_state, state.inner_state
    inner = {"m": params_to_numpy(is_.m), "v": params_to_numpy(is_.v),
             "count": np.asarray(is_.count, np.int32)}
    if is_.master is not None:
        inner["master"] = params_to_numpy(is_.master)
    return {
        "global_params": params_to_numpy(state.global_params),
        "outer_state": {"buf": params_to_numpy(os_.buf),
                        "buf2": params_to_numpy(os_.buf2),
                        "count": np.asarray(os_.count, np.int32)},
        "replica_params": params_to_numpy(state.replica_params),
        "inner_state": inner,
        "outer_t": np.asarray(state.outer_t, np.int32),
        "inner_steps_done": np.asarray(state.inner_steps_done, np.int32),
    }


def stream_state_from_numpy(state, dcfg, *, device) -> streaming.StreamState:
    """A JAX ``StreamState`` whose leaves are numpy arrays -> the port's on
    ``device``. ``armed`` becomes a host float32 array; ``residual`` may be
    None. ``inflight`` is a tuple of None or (payload, mask): the JAX
    payload holds whole (k, ...) leaves, of which the port keeps the
    fragment's band (the partition of ``dcfg``), or, on the packed sharded
    transport, the (k, W) wire bytes, kept as they are."""
    to = lambda t: params_from_numpy(t, device=device)
    inflight = None
    if state.inflight is not None:
        _, regions = streaming._partition(state.base.global_params, dcfg)
        inflight = []
        for regs, slot in zip(regions, state.inflight):
            if slot is None:
                inflight.append(None)
                continue
            payload, mask = slot
            if isinstance(payload, np.ndarray):     # the packed wire
                inflight.append((torch.from_numpy(np.array(payload)).to(
                    device), np.array(mask, np.float32)))
                continue
            band = [None] * len(payload)
            for reg in regs:
                band[reg.leaf] = tensor_from_numpy(
                    streaming._band(np.asarray(payload[reg.leaf]), reg, 1),
                    device=device)
            inflight.append((tuple(band), np.array(mask, np.float32)))
        inflight = tuple(inflight)
    return streaming.StreamState(
        base=state_from_numpy(state.base, device=device),
        pending=to(state.pending),
        armed=np.asarray(state.armed, np.float32).copy(),
        residual=None if state.residual is None else to(state.residual),
        inflight=inflight)


def stream_state_to_numpy(state: streaming.StreamState,
                          dcfg=None) -> dict:
    """The port's streaming state (a full one: on the sharded transport,
    gathered by ``pod_collectives.gather_stream_state``) -> a nested dict
    of numpy arrays keyed by the ``StreamState`` fields: ``base`` as
    ``state_to_numpy``, ``pending``, ``armed``, ``residual`` when there is
    one, and ``inflight`` when the config defers, as {fragment:
    {"payload": {leaf index: (k, band...)}, "mask": (k,)}} for the
    fragments that have a slot. A packed wire payload is decoded into that
    form under ``dcfg`` (the plain decoder, every region's values)."""
    out = {"base": state_to_numpy(state.base),
           "pending": params_to_numpy(state.pending),
           "armed": np.asarray(state.armed, np.float32)}
    if state.residual is not None:
        out["residual"] = params_to_numpy(state.residual)
    if state.inflight is not None:
        regions = None
        out["inflight"] = {}
        for f, slot in enumerate(state.inflight):
            if slot is None:
                continue
            payload = pod_collectives.resolve(slot[0])
            if torch.is_tensor(payload):            # the packed wire
                if dcfg is None:
                    raise ValueError("decoding a packed in-flight wire "
                                     "needs the run's DiLoCoConfig")
                if regions is None:
                    regions = streaming._partition(
                        state.base.global_params, dcfg)[1]
                payload = _decode_packed(payload, regions[f],
                                         state.base.global_params, dcfg)
            out["inflight"][str(f)] = {
                "payload": {str(i): tensor_to_numpy(t)
                            for i, t in enumerate(payload) if t is not None},
                "mask": np.asarray(slot[1], np.float32)}
    return out


def gossip_state_from_numpy(state, *, device) -> gossip.GossipState:
    """A JAX ``GossipState`` whose leaves are numpy arrays -> the port's on
    ``device`` (the (k,) outer counts as an int32 host array)."""
    base = state_from_numpy(DiLoCoState(
        state.global_est, state.outer_state._replace(count=0),
        state.replica_params, state.inner_state, state.outer_t,
        state.inner_steps_done), device=device)
    return gossip.GossipState(
        global_est=base.global_params,
        outer_state=base.outer_state._replace(
            count=np.asarray(state.outer_state.count, np.int32).copy()),
        replica_params=base.replica_params, inner_state=base.inner_state,
        outer_t=base.outer_t, inner_steps_done=base.inner_steps_done)


def gossip_state_to_numpy(state: gossip.GossipState) -> dict:
    """The port's gossip state -> a nested dict of numpy arrays keyed by
    the ``GossipState`` fields, as ``state_to_numpy`` writes a
    ``DiLoCoState``."""
    out = state_to_numpy(DiLoCoState(
        state.global_est, state.outer_state._replace(count=0),
        state.replica_params, state.inner_state, state.outer_t,
        state.inner_steps_done))
    out["global_est"] = out.pop("global_params")
    out["outer_state"]["count"] = np.asarray(state.outer_state.count,
                                             np.int32)
    return out


def _decode_packed(wire, regs, params, dcfg) -> tuple:
    """A fragment's gathered (k, W) packed wire -> per leaf its (k,
    band...) float32 values (None for a leaf it does not touch)."""
    leaves = tree.leaves(params)
    wire = wire.cpu()
    out, off = [None] * len(leaves), 0
    for reg in regs:
        nb = pod_collectives.wire_nbytes(reg.elems, dcfg.outer_grad_dtype)
        g = wire[:, off:off + nb]
        off += nb
        if dcfg.outer_grad_dtype == "bfloat16":
            g = g.contiguous().view(torch.uint16)
        vals = torch.stack([ops.wire_decode(w.contiguous(), reg.elems,
                                            dcfg.outer_grad_dtype,
                                            mode="ref") for w in g])
        out[reg.leaf] = vals.reshape(
            (wire.shape[0],) + streaming._band_shape(leaves[reg.leaf], reg))
    return tuple(out)


def sharded_state_from_numpy(state, dcfg, group) -> streaming.StreamState:
    """A full JAX sharded ``StreamState`` (numpy leaves) -> this rank's
    banded state on the group's device (``pod_collectives.
    shard_stream_state``); ``gather_stream_state`` is the way back."""
    full = stream_state_from_numpy(state, dcfg, device="cpu")
    return pod_collectives.shard_stream_state(full, group)


def async_state_from_numpy(tree_np: dict, *, device):
    """A JAX async state in the ``async_diloco.state_to_tree`` layout, its
    leaves numpy arrays (``jax.tree.map(np.asarray, state_to_tree(s))``)
    -> the port's ``AsyncState`` on ``device``."""
    t = tree.map(lambda a: tensor_from_numpy(a, device=device), tree_np)
    return async_diloco.state_from_tree(t, t["global"])


def async_state_to_numpy(state) -> dict:
    """The port's ``AsyncState`` -> its ``state_to_tree`` layout as a
    nested dict of numpy arrays (bf16 leaves as uint16 bits, the
    counters as 0-d int32 or int64 arrays, as JAX keeps them)."""
    return tree.map(lambda x: tensor_to_numpy(x) if torch.is_tensor(x)
                    else np.asarray(x), async_diloco.state_to_tree(state))
