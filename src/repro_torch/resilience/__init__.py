"""Crash-grade recovery for the port (the JAX ``resilience/`` package):

- ``manager``     — CheckpointManager: atomic npz snapshots with a
                    per-entry sha256 manifest, retention, and a resume
                    picker that skips truncated or corrupt files.
- ``state_codec`` — wraps a round transport's state with the generator
                    state and the round cursor into one checkpoint tree,
                    and hashes trees for bit-identity gates.
- ``guard``       — host-side rolling loss statistics, spike verdicts and
                    the rollback budget (the device-side NaN/Inf
                    rejection is ``core.diloco.outer_step`` under
                    ``dcfg.guard_outer``).
- ``harness``     — subprocess driver for crash and corruption runs.
"""
from . import guard, harness, manager, state_codec  # noqa: F401
from .guard import AnomalyGuard, GuardConfig  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
from .state_codec import leaf_hashes, tree_sha256, unwrap, wrap  # noqa: F401
