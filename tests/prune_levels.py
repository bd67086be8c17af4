"""The sign-prune kernels' multi-level resolve of the threshold, emulated on
the CPU in the kernels' order (shared by ``test_torch_prune_levels.py``).

``csrc/sign_prune.cu`` does not run the 26 bisection steps of
``ref.bisect_threshold`` one at a time over its long rows and its block
rows. It resolves them b at a time (in three passes: 9, 9 and 8):

- the table: from (lo, hi), the 2^b - 1 mids the next b steps can visit,
  in order of position k, t[0] = lo, t[2^b] = hi; node k is reached by
  descending from the root, ``mid = 0.5 * (lo + hi)`` at every step;
- the bins: each |x| in [lo, hi) goes to bin #{k : t[k] <= |x|}. Where
  (lo, hi) spans more than 2^-10 of hi (and 2^-100), from the index
  estimate e = ``(|x| - lo) * 2^b / (hi - lo)``: floor(e) where e lies
  more than a margin from an integer (the nodes' measured distance from
  the even grid, plus the estimate's rounding), else e corrected against
  the table; elsewhere by a b-step search. |x| >= hi goes to the top bin;
  bin 0 is dropped; nothing is binned when hi is NaN or infinite;
- the walk: b steps from the root; at node k of half width s the count is
  the count at the interval's upper end plus bins k .. k + s - 1.

The emulation follows those steps in float32 with a level split given as
an argument; a split of one level at a time, or of all 26 in one pass
(binned by the search: a table of 2^26 nodes is not built), is the same
resolve at its two ends.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

WIDE = 2.0 ** -10      # the kernels' test for the index estimate
# the level splits the tests hold to the plain bisection
SPLITS = [(9, 9, 8), (13, 13), (26,), (1,) * 26]


def _mid(lo, hi):
    return ref.f32(0.5) * (lo + hi)


def table(lo, hi, b):
    """t[0 .. 2^b] (float32): lo, the nodes in order, hi; each node computed
    by descending from the root, as the kernels' ``build_table``."""
    n = 1 << b
    t = torch.empty(n + 1, dtype=torch.float32)
    t[0], t[n] = lo, hi
    k = torch.arange(1, n)
    lo_k, hi_k = lo.expand(n - 1).clone(), hi.expand(n - 1).clone()
    pos = torch.full((n - 1,), n >> 1)
    s = n >> 2
    for _ in range(b):
        mid = _mid(lo_k, hi_k)
        at = pos == k
        t[k[at]] = mid[at]
        right = k > pos
        lo_k = torch.where(right, mid, lo_k)
        hi_k = torch.where(right, hi_k, mid)
        pos = torch.where(right, pos + s, pos - s)
        s >>= 1
    return t


def bins_by_search(a, lo, hi, b):
    """bin(|x|) of each entry of ``a`` by the b-step search, each node
    computed on the way down (the table's values without the table)."""
    j = torch.zeros(a.shape, dtype=torch.int64)
    lo_e, hi_e = lo.expand(a.shape).clone(), hi.expand(a.shape).clone()
    for s in (1 << i for i in range(b - 1, -1, -1)):
        mid = _mid(lo_e, hi_e)
        up = mid <= a
        j = torch.where(up, j + s, j)
        lo_e = torch.where(up, mid, lo_e)
        hi_e = torch.where(up, hi_e, mid)
    return j


def margin(t, lo, hi, b, inv):
    """The index estimate's margin in grid steps, as the kernels compute
    it: the nodes' largest distance from the even grid lo + k (hi - lo) /
    2^b (float64, rounded up to float32), times inv and 1 + 2^-20, plus
    2^b · 2^-21 for the estimate's own rounding; 1 (no floor taken) unless
    below 0.25."""
    n = 1 << b
    w = hi.double() - lo.double()
    grid = lo.double() + torch.arange(1, n, dtype=torch.float64) * (w / n)
    d = (t[1:n].double() - grid).abs().max()
    f = d.float()
    if f.double() < d:
        f = torch.nextafter(f, torch.tensor(float("inf")))
    m = f * inv * torch.tensor(1.0 + 2.0 ** -20) \
        + torch.tensor(n * 2.0 ** -21, dtype=torch.float32)
    return m if bool(m < 0.25) else torch.tensor(1.0)


def bins_by_estimate(a, lo, hi, b):
    """bin(|x|) from the index estimate e: floor(e) where e lies more than
    the margin from an integer, else e corrected against the table."""
    t = table(lo, hi, b)
    n = (1 << b) - 1
    inv = torch.tensor(float(n + 1), dtype=torch.float32) / (hi - lo)
    e = (a - lo) * inv
    r = e - e.floor()
    m = margin(t, lo, hi, b, inv)
    fast = (r > m) & (r < 1.0 - m)
    j = e.clamp(0.0, float(n)).to(torch.int64)
    while True:
        up = ~fast & (j < n) & (t[(j + 1).clamp(max=n)] <= a)
        if not up.any():
            break
        j = j + up.long()
    while True:
        down = ~fast & (j > 0) & (t[j] > a)
        if not down.any():
            break
        j = j - down.long()
    return torch.where(fast, e.floor().to(torch.int64).clamp(max=n), j)


def resolve_pass(mag, lo, hi, b, keep, estimate=True):
    """(lo, hi) after b bisection steps from (lo, hi), counted as one pass
    of the kernels counts them. mag: (C,) float32 >= 0 (NaN allowed)."""
    n = (1 << b) - 1
    if bool(torch.isfinite(hi)):
        above = int((mag >= hi).sum())
        inside = mag[(mag < hi) & (mag >= lo)]
        w = hi - lo
        if estimate and b <= 13 and bool(torch.isfinite(w)) \
                and bool(w > hi * WIDE) and bool(w > 2.0 ** -100):
            j = bins_by_estimate(inside, lo, hi, b)
        else:
            j = bins_by_search(inside, lo, hi, b)
        j = torch.cat([j[j > 0], torch.full((above,), n)])
    else:
        j = torch.zeros(0, dtype=torch.int64)
    j = j.sort().values
    k, at_top = 1 << (b - 1), 0
    for s in (1 << i for i in range(b - 1, -1, -1)):
        mid = _mid(lo, hi)
        part = int(torch.searchsorted(j, k + s) - torch.searchsorted(j, k))
        c = at_top + part
        if c > keep:
            lo, k = mid, k + (s >> 1)
        else:
            hi, at_top, k = mid, c, k - (s >> 1)
    return lo, hi


def resolve(mag, keep, split=(9, 9, 8), estimate=True):
    """The threshold hi (0-d float32) of one row's magnitudes ``mag`` by
    the passes of ``split`` (levels adding up to 26)."""
    assert sum(split) == ref.PRUNE_ITERS and all(b >= 1 for b in split)
    lo = torch.zeros((), dtype=torch.float32)
    hi = mag.amax() * ref.HI_SCALE + ref.HI_FLOOR
    for b in split:
        lo, hi = resolve_pass(mag, lo, hi, b, keep, estimate)
    return hi


def sign_prune_row(x, frac, split=(9, 9, 8), estimate=True):
    """One row (C,) pruned with the threshold from ``resolve`` and the
    election and mask of ``ref.sign_prune_parts``."""
    xf = x.float()
    mag = xf.abs()
    hi = resolve(mag, ref.keep_count(frac, x.shape[-1]), split, estimate)
    elected = ref.sign_prune_parts(x[None], frac)[0][0, 0]
    keep = (torch.sign(xf) == elected) & (mag >= hi)
    return torch.where(keep, x, torch.zeros_like(x))
