"""Tolerances that hold a round under a bf16 precision policy to another
run of it (the card against the CPU, the port against the JAX reference).

``tests/test_torch_mixed.py`` states why each tolerance is what it is;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` apply the same ones.
"""
from __future__ import annotations

import math

import numpy as np

from . import tree
from .convert import bf16_to_f32


def ulp_bf16(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def mismatch_shares(got: dict, want: dict, *, H: int, pure: bool) -> dict:
    """For two states of ``state_to_numpy``'s form, each leaf's share of
    entries outside the tolerance of a round under a bf16 policy: float32
    leaves atol 1e-5, rtol 1e-4 (under the pure policy, whose globals are
    updated from bf16 replicas, plus two bf16 ulps of the leaf's largest
    replica value); bf16 leaves within H bf16 ulps of the leaf's largest
    magnitude (a step's rounding may land one ulp apart, over H steps);
    other leaves exactly. ``tests/test_torch_mixed.py`` states why."""
    want_paths = dict(tree.paths(want))
    got_paths = dict(tree.paths(got))
    if sorted(got_paths) != sorted(want_paths):
        raise ValueError("the two states have different leaves")
    reps = {p[len("replica_params"):]: v for p, v in want_paths.items()
            if p.startswith("replica_params.")}
    shares = {}
    for path, b in want_paths.items():
        a = got_paths[path]
        if a.dtype != b.dtype:
            raise ValueError(f"{path}: {a.dtype} against {b.dtype}")
        if a.dtype == np.uint16:
            bf = bf16_to_f32(b)
            ok = np.abs(bf16_to_f32(a) - bf) <= H * ulp_bf16(
                float(np.abs(bf).max(initial=0.0)))
        elif a.dtype == np.float32:
            atol = 1e-5
            rep = next((v for suffix, v in reps.items()
                        if path.endswith(suffix)), None)
            if pure and rep is not None:
                atol += 2 * ulp_bf16(float(np.abs(bf16_to_f32(rep)).max()))
            ok = np.abs(a - b) <= atol + 1e-4 * np.abs(b)
        else:
            ok = np.asarray(a == b)
        shares[path] = 1.0 - float(np.mean(ok))
    return shares
