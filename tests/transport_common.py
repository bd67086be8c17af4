"""Shared helper of the transport parity files
(``tests/test_torch_streaming.py``, ``tests/test_torch_stream_*.py``,
``tests/test_torch_async*.py``): the JAX package's sends, recorded as its
rounds run, for ``check.TransportSteps.explain``. Not a test module."""
from __future__ import annotations

import contextlib

import jax
import numpy as np


@contextlib.contextmanager
def jax_sends():
    """Within the block, every value the JAX package hands its quantized
    transport (``ops.quant_roundtrip`` off float32, ``ops.wire_encode``)
    is kept, as it runs, as 1-D float32 rows (one a replica under the
    rounds' vmap: a whole leaf, or a flat payload). The functions are
    wrapped where the JAX code looks them up, so the rounds must be
    traced inside the block. Yields the list the rows go to."""
    from repro.kernels import ops as jops
    rows = []

    def keep(v):
        rows.append(np.asarray(v, np.float32).reshape(-1))

    quant, encode = jops.quant_roundtrip, jops.wire_encode

    def quant_roundtrip(x, dtype, **kw):
        if dtype != "float32":
            jax.debug.callback(keep, x)
        return quant(x, dtype, **kw)

    def wire_encode(x, dtype, **kw):
        jax.debug.callback(keep, x)
        return encode(x, dtype, **kw)

    jops.quant_roundtrip, jops.wire_encode = quant_roundtrip, wire_encode
    try:
        yield rows
        jax.effects_barrier()
    finally:
        jops.quant_roundtrip, jops.wire_encode = quant, encode
