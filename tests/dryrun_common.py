"""Shared helper of the dry-run parity files (``tests/test_torch_specs.py``,
``tests/test_torch_dryrun.py``). Not a test module."""
from __future__ import annotations

import importlib
import os

import jax


def import_jax_dryrun():
    """The JAX dry run's module. Importing it rewrites ``XLA_FLAGS`` to 512
    fake devices: it is imported after this process's backend is up, and
    the variable is put back, so later JAX work on the same worker keeps
    its own device count."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
