"""The sign-prune kernels' multi-level resolve of the threshold against the
plain 26-step bisection, bit for bit, on the CPU.

``csrc/sign_prune.cu`` counts several bisection levels per pass over a
row: it bins each entry by the tree of mids those levels can visit and
walks the row's histogram down the tree (``tests/prune_levels.py``
emulates it in the kernels' order). The kernels run only on the card;
this file holds the emulation, under the splits (9, 9, 8) (the long
rows'), (13, 13), (26,) and one level at a time, with bins from the index
estimate and from the search, to ``ref.bisect_threshold`` on rows chosen
to break it: ties, zeros, subnormals, infinities, NaN, magnitudes whose
mids overflow, keep = 1 and keep >= C. Equal means the same bits (NaN
where the plain version has NaN).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from prune_levels import (SPLITS, resolve, sign_prune_row,  # noqa: E402
                          table)
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

FLT_MAX = float(np.finfo(np.float32).max)


def _rows():
    """name -> (row (C,) float32, keep)."""
    rng = np.random.default_rng(19)
    g = rng.standard_normal(1000).astype(np.float32)
    heavy = (rng.standard_cauchy(1000) * 10.0 ** rng.integers(-20, 20, 1000)
             ).astype(np.float32)
    dup = (rng.integers(-3, 4, 999) * 0.25).astype(np.float32)
    sub = (rng.standard_normal(500) * 1e-40).astype(np.float32)
    sub[::3] = 0.0
    inf = g[:300].copy()
    inf[[7, 100]] = np.inf, -np.inf
    nan = g[:300].copy()
    nan[42] = np.nan
    # mids past FLT_MAX on the tree's right edge (finite max), and a max
    # whose hi0 overflows
    big = (rng.uniform(-1.0, 1.0, 400) * 3.39e38).astype(np.float32)
    top = big.copy()
    top[5] = FLT_MAX
    return {
        "gaussian": (g, 500), "heavy_tailed": (heavy, 300),
        "all_equal": (np.full(640, 0.37, np.float32), 320),
        "duplicates": (dup, 400), "all_zero": (np.zeros(256, np.float32), 128),
        "subnormal": (sub, 200), "inf": (inf, 150), "nan": (nan, 150),
        "overflowing_mids": (big, 200), "max_float": (top, 200),
        "keep_1": (g, 1), "keep_C": (g, 1000), "keep_above_C": (g, 1001),
        "C_1": (g[:1], 1),
    }


ROWS = _rows()


def _same(a, b):
    a, b = torch.as_tensor(a).reshape(()), torch.as_tensor(b).reshape(())
    return bool(a.isnan() & b.isnan()) or a.view(torch.int32).item() == \
        b.view(torch.int32).item()


@pytest.mark.parametrize("estimate", [True, False],
                         ids=["estimate", "search"])
@pytest.mark.parametrize("split", SPLITS,
                         ids=["9_9_8", "13_13", "26", "1x26"])
@pytest.mark.parametrize("name", list(ROWS))
def test_resolve_equals_bisection(name, split, estimate):
    row, keep = ROWS[name]
    mag = torch.from_numpy(row).abs()
    want = ref.bisect_threshold(mag[None], keep)
    assert _same(resolve(mag, keep, split, estimate), want), name


def test_rows_reach_the_corners():
    """The adversarial rows do what they are there for: the NaN row's
    threshold is NaN, the infinite rows' infinite, the overflowing row's
    mids overflow with a finite max, the subnormal row's entries are
    subnormal and lie below every mid (the 1e-30 floor keeps 26 halvings
    above 1.4e-38)."""
    def hi(name):
        row, keep = ROWS[name]
        return ref.bisect_threshold(torch.from_numpy(row).abs()[None],
                                    keep)[0, 0]
    assert hi("nan").isnan() and hi("inf").isinf() and hi("max_float").isinf()
    big = torch.from_numpy(ROWS["overflowing_mids"][0]).abs()
    assert torch.isfinite(big.amax() * ref.HI_SCALE + ref.HI_FLOOR)
    assert hi("overflowing_mids").isinf()
    sub = torch.from_numpy(ROWS["subnormal"][0]).abs()
    tiny = np.finfo(np.float32).tiny
    assert ((sub > 0) & (sub < tiny)).sum() > 300
    assert sub.amax() < hi("subnormal") < 2 * tiny


def test_entries_on_the_nodes():
    """Entries at the first pass's nodes and one ulp to either side, where
    the index estimate's floor is wrong if taken without its margin, under
    every keep from 1 to C in steps of 5."""
    top = torch.tensor(1.0)
    hi0 = top * ref.HI_SCALE + ref.HI_FLOOR
    nodes = table(torch.tensor(0.0), hi0, 9)[1:-1]
    up = torch.nextafter(nodes, torch.tensor(float("inf")))
    down = torch.nextafter(nodes, torch.tensor(0.0))
    mag = torch.cat([nodes, up, down]).clamp(max=top)
    mag = torch.cat([mag, top[None]])
    for keep in range(1, mag.numel() + 1, 5):
        want = ref.bisect_threshold(mag[None], keep)
        assert _same(resolve(mag, keep), want), keep


@pytest.mark.parametrize("name,frac", [("gaussian", 0.5),
                                       ("duplicates", 0.9)])
def test_pruned_row_equals_jax(name, frac):
    """The emulated threshold in the plain version's election and mask
    against the JAX ``ref.sign_prune``, bit for bit."""
    row = ROWS[name][0]
    got = sign_prune_row(torch.from_numpy(row), frac).numpy()
    want = np.asarray(jref.sign_prune(jnp.asarray(row[None]), frac))[0]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


_FLOATS = st.floats(width=32, allow_nan=False, allow_infinity=False,
                    allow_subnormal=True)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(row=st.lists(_FLOATS, min_size=1, max_size=64),
       keep=st.integers(1, 65), split=st.sampled_from(SPLITS),
       estimate=st.booleans())
def test_resolve_property(row, keep, split, estimate):
    mag = torch.tensor(row, dtype=torch.float32).abs()
    want = ref.bisect_threshold(mag[None], keep)
    assert _same(resolve(mag, keep, split, estimate), want)
