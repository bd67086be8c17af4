"""Parameters and DiLoCo state to and from numpy trees.

The port cannot reproduce ``jax.random``, so parity runs start from
parameters (or a whole state) made on the JAX side and handed over as
numpy arrays (``jax.tree.map(np.asarray, tree)``): nested dicts with the
same key paths and shapes. The state functions read and write the
fields of the JAX ``DiLoCoState`` by name, so every leaf can be compared.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tree
from .core.diloco import DiLoCoState
from .core.outer_opt import OuterState
from .optim.adamw import AdamWState


def params_from_numpy(params, *, device):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device`` (float32 leaves; copies)."""
    return tree.map(lambda a: torch.tensor(np.asarray(a), device=device),
                    params)


def params_to_numpy(params):
    return tree.map(lambda t: t.detach().cpu().numpy(), params)


def state_from_numpy(state, *, device) -> DiLoCoState:
    """A JAX ``DiLoCoState`` whose leaves are numpy arrays (float32
    policy, no master) -> the port's state on ``device``."""
    if state.inner_state.master is not None:
        raise NotImplementedError("mixed-precision state is not ported yet "
                                  "(ROADMAP.md, port queue: mixed-precision "
                                  "policy)")
    to = lambda t: params_from_numpy(t, device=device)
    os_, is_ = state.outer_state, state.inner_state
    return DiLoCoState(
        global_params=to(state.global_params),
        outer_state=OuterState(to(os_.buf), to(os_.buf2), int(os_.count)),
        replica_params=to(state.replica_params),
        inner_state=AdamWState(to(is_.m), to(is_.v),
                               np.asarray(is_.count, np.int32)),
        outer_t=int(state.outer_t),
        inner_steps_done=int(state.inner_steps_done))


def state_to_numpy(state: DiLoCoState) -> dict:
    """The port's state -> a nested dict of numpy arrays keyed like the
    JAX ``DiLoCoState`` fields (counters as int32 arrays)."""
    os_, is_ = state.outer_state, state.inner_state
    return {
        "global_params": params_to_numpy(state.global_params),
        "outer_state": {"buf": params_to_numpy(os_.buf),
                        "buf2": params_to_numpy(os_.buf2),
                        "count": np.asarray(os_.count, np.int32)},
        "replica_params": params_to_numpy(state.replica_params),
        "inner_state": {"m": params_to_numpy(is_.m),
                        "v": params_to_numpy(is_.v),
                        "count": np.asarray(is_.count, np.int32)},
        "outer_t": np.asarray(state.outer_t, np.int32),
        "inner_steps_done": np.asarray(state.inner_steps_done, np.int32),
    }
