"""Tolerances that hold a round under a bf16 precision policy, a
streaming round, or an async run, to another run of it (the card against
the CPU, the port against the JAX reference); and a served request to
its reference (``serve_mismatches``).

``tests/test_torch_mixed.py``, ``tests/test_torch_streaming.py`` and
``tests/test_torch_async.py`` state why each tolerance is what it is;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` apply the same ones.
"""
from __future__ import annotations

import math

import numpy as np

from . import tree
from .convert import bf16_to_f32
from .kernels.ref import INV_INT4_LEVELS, QUANT_BLOCK


def ulp_bf16(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def bf16_steps(x) -> np.ndarray:
    """One bf16 ulp at each entry's magnitude (0 at 0), float64."""
    mag = np.abs(np.asarray(x, np.float64))
    return np.where(mag > 0, np.exp2(np.floor(np.log2(
        np.where(mag > 0, mag, 1.0))) - 7), 0.0)


def _values(x: np.ndarray) -> np.ndarray:
    """A leaf's values: bf16 bits (uint16) widened to float32."""
    return bf16_to_f32(x) if x.dtype == np.uint16 else x


def _tolerances(want: dict, *, H: int, pure: bool) -> dict:
    """Per leaf path of a state of ``state_to_numpy``'s form, the
    tolerance on |a - b| of ``mismatch_shares`` (a scalar or per entry),
    or None for a leaf compared exactly."""
    want_paths = dict(tree.paths(want))
    reps = {p[len("replica_params"):]: v for p, v in want_paths.items()
            if p.startswith("replica_params.")}
    tols = {}
    for path, b in want_paths.items():
        if b.dtype == np.uint16:
            tols[path] = H * ulp_bf16(float(np.abs(_values(b)).max(
                initial=0.0)))
        elif b.dtype == np.float32:
            atol = 1e-5
            rep = next((v for suffix, v in reps.items()
                        if path.endswith(suffix)), None)
            if pure and rep is not None:
                atol += 2 * ulp_bf16(float(np.abs(_values(rep)).max()))
            tols[path] = atol + 1e-4 * np.abs(b)
        else:
            tols[path] = None
    return tols


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
    tols = _tolerances(want, H=H, pure=pure)
    shares = {}
    for path, b in want_paths.items():
        a = got_paths[path]
        if a.dtype != b.dtype:
            raise ValueError(f"{path}: {a.dtype} against {b.dtype}")
        if tols[path] is None:
            ok = np.asarray(a == b)
        else:
            ok = np.abs(_values(a) - _values(b)) <= tols[path]
        shares[path] = 1.0 - float(np.mean(ok))
    return shares


# Under a quantized transport (int4 or bf16) an upstream last-bit
# difference can move a value across a rounding boundary of the transport
# and flip its code: the transported value then differs by one code step
# (the block's int4 scale, or one bf16 ulp), and the residual, the pending
# reduce and what they update differ at that entry. Every entry outside
# the round's tolerance must be finite where the other run is finite and,
# given the run's ``TransportSteps``, within ``allow`` code steps of it.
# Where both runs' sends were recorded (``TransportSteps.explain``), the
# premise is tested directly: an entry outside is explained when every
# send at its position whose code differed between the runs was a
# straddle, the two runs' pre-rounding values on either side of one code
# boundary and no further apart than the run's float32 bound (atol 1e-5 +
# rtol 1e-4 of the operand params, the async atol per application);
# explained entries are counted apart (``TransportSteps.explained``), and
# at most this share of a leaf's entries may lie outside unexplained. A
# bf16 step is 2^-8 of the value, where int4's is a seventh of the block's
# largest: a last-bit difference of relative size e crosses a bf16
# boundary with probability about e·2^8 (0.26 % at e = 1e-5), far more
# often than an int4 one, and on a leaf of fewer than 1/limit entries a
# single unexplained flip breaks the limit. The largest shares the JAX
# parity grid of ``tests/test_torch_stream_*.py`` and
# ``tests/test_torch_streaming.py`` read before straddles were counted
# apart: int4 4.7e-4, bf16 1.4e-3. The async runs of
# ``tests/test_torch_async*.py`` (one flat payload per arrival, six to
# eight arrivals) are held to the same limits.
TRANSPORT_FLIP_SHARE = {"float32": 0.0, "int4": 1e-3, "bfloat16": 5e-3}
# the float32 bound a straddle's two pre-rounding values may lie apart:
# atol + rtol · |operand param| (an async send: atol per application)
STRADDLE_ATOL, STRADDLE_RTOL = 1e-5, 1e-4


class TransportSteps:
    """The transport's code step at every entry of a streaming run, for
    bounding how far a flipped code may move an entry.

    Used as ``with TransportSteps(params, dcfg) as steps:`` around the
    rounds of the run taken as the reference. For each send it records,
    per replica and entry of the leaf, the step of the code the entry was
    sent with: int4, its 128-entry block's scale (amax·INV_INT4_LEVELS of
    the block the transport quantized); bfloat16, one bf16 ulp at the sent
    value. Under sign pruning the row's threshold (the smallest magnitude
    the pruning kept) is added: an entry at the threshold may be sent in
    one run and dropped in the other. ``step[i]`` keeps the largest step
    replica i's entry took over the run.

    ``stream_mismatch_shares`` lets an entry outside the round's
    tolerance lie up to ``allow`` = 1 + outer_lr·(1 + momentum) steps
    beyond it, taking the largest step any replica took at that position:
    a flipped code moves a transported value, its residual and the
    weighted mean of the replicas' values by at most one step; the outer
    Nesterov step carries the mean's into the momentum (one step) and the
    globals (outer_lr·(1 + momentum) steps), which the replicas adopt and
    the next sends take in. It reads the sends by wrapping
    ``streaming._send_window`` (which leaf and flat window a send takes),
    ``ops.sign_prune`` and ``ops.quant_roundtrip`` (the values sent).

    Under ``dcfg.transport == "async"`` a send is one flat payload (the
    tree's leaves in order, a worker's delta plus its residual) through
    ``ops.wire_encode``, which it wraps instead; the steps are those of
    the flat payload's blocks (which straddle leaves), one row for all
    workers. A flipped code moves the applied value by at most one step
    times the arrival's weight (≤ 1), and the outer step carries it as in
    a round: the same ``allow``. An arrival's delta is taken against its
    own snapshot, so a shifted global shifts both terms alike.

    On the packed sharded transport a send is a region of the band
    through ``pod_collectives.encode_wire``, which it wraps too (the int4
    blocks start at the region); each pod rank records its own band's
    sends (``record``), held together by ``of_ranks``.

    Each send's pre-rounding values are kept too (``sends``: per replica,
    the window of the leaf, or the flat payload, the transport rounded,
    beside the operand params' magnitudes there), so that ``explain`` can
    hold them against another run's sends of the same rounds."""

    def __init__(self, params, dcfg):
        from .core import streaming
        self.dtype = dcfg.outer_grad_dtype
        self.flat = getattr(dcfg, "transport", "simulated") == "async"
        self.leaf_of = {p: i for i, (p, _) in enumerate(tree.paths(params))}
        shapes = [tuple(x.shape) for x in tree.leaves(params)]
        self.n = [math.prod(s) for s in shapes]
        self.cols = [n if len(s) <= 1 else math.prod(s[1:])
                     for n, s in zip(self.n, shapes)]
        self.per = [n // s[0] if s else n for n, s in zip(self.n, shapes)]
        self.step = [np.zeros((1 if self.flat else int(dcfg.k), n))
                     for n in self.n]
        self.regions = None if self.flat else \
            streaming._partition(params, dcfg)[1]
        self.allow = 1.0 + float(dcfg.outer_lr) * (
            1.0 + float(dcfg.outer_momentum))
        self._send = None
        self._params = tree.leaves(params)
        self.sends = []
        # per leaf and replica row, the positions where a send's code
        # differed from the other run's: explained straddles, other flips
        self.straddles = self.flips = None
        self.explained = {}          # leaf path -> entries explained
        # the flips no straddle explains: (send, replica row, flat
        # position in the leaf or payload, leaf index or None, this run's
        # value, the other's, their float32 bound, codes apart)
        self.unexplained = []

    def __enter__(self):
        from .core import streaming
        from .kernels import ops
        if self.flat:
            encode = self._saved = ops.wire_encode

            def wire_encode(x, dtype, **kw):
                flat = x.detach().cpu().numpy().reshape(-1)
                self._record_flat(flat)
                ref = np.concatenate([np.abs(t.detach().cpu().numpy())
                                      .reshape(-1) for t in self._params])
                self.sends.append({"leaf": None, "a": 0, "x": flat[None],
                                   "ref": ref, "atol": STRADDLE_ATOL * (
                                       len(self.sends) + 1)})
                return encode(x, dtype, **kw)

            ops.wire_encode = wire_encode
            return self
        from .core import pod_collectives
        window, prune, quant, wire = (streaming._send_window, ops.sign_prune,
                                      ops.quant_roundtrip,
                                      pod_collectives.encode_wire)
        self._saved = window, prune, quant, wire
        windows = []                 # the packed sender's, in region order

        def send_window(leaf, reg, qdtype, pr):
            w = window(leaf, reg, qdtype, pr)
            off = 0 if w[0] is None else w[0] * (self.n[reg.leaf]
                                                 // int(leaf.shape[0]))
            self._send = {"leaf": reg.leaf, "a": w[2], "off": off,
                          "thr": None, "ref": np.abs(
                              leaf.detach().cpu().numpy().reshape(-1)
                              [w[2]:w[3]])}
            windows.append(self._send)
            return w

        def encode_wire(d_regions, dtype, **kw):
            # the packed sharded sender: one (k_loc, n) region a window
            # of the last ones taken, its int4 blocks from the region on
            for d, win in zip(d_regions, windows[-len(d_regions):]):
                self._send = win
                self._record(d.detach().cpu().numpy())
            windows.clear()
            self._send = None
            return wire(d_regions, dtype, **kw)

        def sign_prune(x, frac, **kw):
            out = prune(x, frac, **kw)
            if self._send is not None:
                mag = np.abs(out.detach().cpu().numpy())
                self._send["thr"] = np.where(
                    mag > 0, mag, np.inf).min(axis=1, initial=np.inf)
            return out

        def quant_roundtrip(x, dtype, **kw):
            if self._send is not None and kw.get("stacked"):
                self._record(x.detach().cpu().numpy().reshape(x.shape[0],
                                                              -1))
                self._send = None
                windows.clear()
            return quant(x, dtype, **kw)

        streaming._send_window = send_window
        ops.sign_prune = sign_prune
        ops.quant_roundtrip = quant_roundtrip
        pod_collectives.encode_wire = encode_wire
        return self

    def __exit__(self, *exc):
        from .core import pod_collectives, streaming
        from .kernels import ops
        if self.flat:
            ops.wire_encode = self._saved
            return False
        (streaming._send_window, ops.sign_prune, ops.quant_roundtrip,
         pod_collectives.encode_wire) = self._saved
        return False

    def record(self) -> dict:
        """What the run's sends left: picklable, for a pod rank to hand to
        the process that holds the runs against each other
        (``of_ranks``)."""
        return {"sends": self.sends, "step": self.step}

    @classmethod
    def of_ranks(cls, params, dcfg, ref: list, other: list):
        """The steps of a sharded run whose pod ranks recorded their own
        bands' sends (``record``, rank by rank: the reference run's
        ``ref`` and the other run's ``other``), each rank's sends
        explained against the same rank's of the other run: the largest
        step, and a straddle or another flip, at a position on any
        rank."""
        out = cls(params, dcfg)
        out.straddles = [np.zeros(st.shape, bool) for st in out.step]
        out.flips = [np.zeros(st.shape, bool) for st in out.step]
        for a, b in zip(ref, other):
            mine, theirs = cls(params, dcfg), cls(params, dcfg)
            mine.sends, mine.step = a["sends"], a["step"]
            theirs.sends = b["sends"]
            mine.explain(theirs)
            for li in range(len(out.step)):
                np.maximum(out.step[li], mine.step[li], out=out.step[li])
                out.straddles[li] |= mine.straddles[li]
                out.flips[li] |= mine.flips[li]
            out.unexplained += mine.unexplained
        return out

    def _code_steps(self, x):
        """(k, w) values sent -> the step of the code each one took."""
        k, w = x.shape
        if self.dtype == "int4":
            blk = QUANT_BLOCK
            pad = np.zeros((k, -(-w // blk) * blk), np.float32)
            pad[:, :w] = np.abs(x)
            amax = pad.reshape(k, -1, blk).max(axis=2)
            return np.repeat(amax * np.float32(INV_INT4_LEVELS), blk,
                             axis=1)[:, :w].astype(np.float64)
        if self.dtype == "bfloat16":
            return bf16_steps(x)
        return np.zeros((k, w))

    def _record_flat(self, x):
        step = self._code_steps(x[None])[0]
        off = 0
        for li, n in enumerate(self.n):
            np.maximum(self.step[li][0], step[off:off + n],
                       out=self.step[li][0])
            off += n

    def _record(self, x):
        k, w = x.shape
        s = self._send
        self.sends.append({"leaf": s["leaf"], "a": s["a"], "x": x.copy(),
                           "ref": s["ref"], "atol": STRADDLE_ATOL})
        step = self._code_steps(x)
        if s["thr"] is not None:
            cols = self.cols[s["leaf"]]
            rows = (s["a"] - s["off"] + np.arange(w)) // cols
            thr = s["thr"].reshape(k, -1)[:, rows]
            step = step + np.where(np.isfinite(thr), thr, 0.0)
        tgt = self.step[s["leaf"]][:, s["a"]:s["a"] + w]
        if k != tgt.shape[0]:          # a pod rank's band of the replicas
            step = step.max(axis=0, keepdims=True)
        np.maximum(tgt, step, out=tgt)

    def _codes(self, x):
        """(k, w) values -> each one's transport code as an ordered integer
        (int4: the code of its 128-entry block; bfloat16: the bf16 value's
        rank among the bf16 numbers), so that one code boundary lies
        between two values exactly when their codes differ by one."""
        if self.dtype == "int4":
            k, w = x.shape
            blk = QUANT_BLOCK
            pad = np.zeros((k, -(-w // blk) * blk), np.float32)
            pad[:, :w] = x
            rows = pad.reshape(-1, blk)
            amax = np.abs(rows).max(axis=1, keepdims=True)
            scale = amax * np.float32(INV_INT4_LEVELS)
            q = np.rint(rows / np.where(scale > 0, scale, np.float32(1)))
            return np.clip(q, -7, 7).reshape(k, -1)[:, :w].astype(np.int64)
        bits = (np.ascontiguousarray(x, np.float32).view(np.uint32)
                + np.uint32(0x7FFF) + ((np.ascontiguousarray(
                    x, np.float32).view(np.uint32) >> 16) & 1)) >> 16
        mag = (bits & 0x7FFF).astype(np.int64)
        return np.where(bits & 0x8000, -mag, mag)

    def explain(self, other):
        """Hold this run's sends against ``other``'s, the same rounds run
        elsewhere: another ``TransportSteps`` (its sends paired in order)
        or a list of 1-D rows of pre-rounding values (each a replica's
        whole leaf, or a flat payload, as the JAX package quantizes them;
        each window of this run is paired with the row of that size that
        lies nearest it). At every position whose code differs between
        the two runs, records whether the send was a straddle (the codes
        one apart, the values within the send's float32 bound: ``atol`` +
        ``STRADDLE_RTOL`` · |operand param|) or another flip; the
        tolerance checks then count the entries explained apart."""
        shape = lambda st: np.zeros(st.shape, bool)
        self.straddles = [shape(st) for st in self.step]
        self.flips = [shape(st) for st in self.step]
        rows = None if isinstance(other, TransportSteps) else \
            [np.asarray(r, np.float32).reshape(-1) for r in other]
        if rows is None and len(other.sends) != len(self.sends):
            raise ValueError(f"{len(self.sends)} sends against "
                             f"{len(other.sends)}")
        for n, s in enumerate(self.sends):
            x = s["x"]
            w = x.shape[1]
            if rows is None:
                theirs = other.sends[n]["x"]
            else:
                size = w if s["leaf"] is None else self.n[s["leaf"]]
                cands = [r[s["a"]:s["a"] + w] for r in rows
                         if r.size == size]
                if not cands:
                    raise ValueError(f"no send of {size} entries to pair")
                theirs = np.stack([min(cands, key=lambda c: float(
                    np.abs(c - row).max())) for row in x])
            dc = np.abs(self._codes(x) - self._codes(theirs))
            bound = s["atol"] + STRADDLE_RTOL * s["ref"]
            near = np.abs(x.astype(np.float64) - theirs) <= bound
            ok, bad = (dc == 1) & near, (dc > 0) & ~((dc == 1) & near)
            for row, col in zip(*np.nonzero(bad)):
                self.unexplained.append(
                    (n, int(row), s["a"] + int(col), s["leaf"],
                     float(x[row, col]), float(theirs[row, col]),
                     float(np.broadcast_to(bound, x.shape[-1:])[col]),
                     int(dc[row, col])))
            if s["leaf"] is not None:
                li, a = s["leaf"], s["a"]
                if ok.shape[0] != self.step[li].shape[0]:   # a rank's band
                    ok = ok.any(axis=0, keepdims=True)
                    bad = bad.any(axis=0, keepdims=True)
                self.straddles[li][:, a:a + w] |= ok
                self.flips[li][:, a:a + w] |= bad
                continue
            off = 0
            for li, n_li in enumerate(self.n):
                self.straddles[li][0] |= ok[0, off:off + n_li]
                self.flips[li][0] |= bad[0, off:off + n_li]
                off += n_li

    def explained_at(self, path: str, size: int):
        """After ``explain``: for the state leaf at ``path`` of ``size``
        entries, whether each entry's position saw a straddle and no other
        flip (``of``'s layout); None for a leaf that holds no transported
        value, or before ``explain``."""
        if self.straddles is None:
            return None
        ok = self.of(path, size, self.straddles)
        if ok is None:
            return None
        return ok & ~self.of(path, size, self.flips)

    def of(self, path: str, size: int, table=None):
        """For the state leaf at ``path`` (a path of
        ``convert.stream_state_to_numpy``'s form) of ``size`` entries, the
        largest step any replica took at each of its positions, flattened
        (repeated over the leading k of a per-replica leaf; the band's for
        an in-flight payload); None for a leaf that holds no transported
        value (armed, masks, counters). ``table``: per leaf and replica
        row, another record of the sends to read the same way."""
        table = self.step if table is None else table
        parts = path.split(".")
        if self.flat and parts[-1] == "residual":
            return np.concatenate([st.max(axis=0) for st in table])
        if parts[0] == "inflight":
            if parts[2] != "payload":
                return None
            li = int(parts[3])
            reg = next(r for r in self.regions[int(parts[1])]
                       if r.leaf == li)
            step = table[li].max(axis=0)
            if reg.start is not None:
                step = step[reg.start * self.per[li]:reg.stop * self.per[li]]
        else:
            li = next((i for p, i in sorted(self.leaf_of.items(),
                                            key=lambda t: -len(t[0]))
                       if path.endswith("." + p)), None)
            if li is None:
                return None
            step = table[li].max(axis=0)
        return np.tile(step, size // step.size)


def _paired(got: dict, want: dict) -> list:
    """[(path, got leaf, want leaf)] of two states of one layout; raises
    when their leaves or dtypes differ."""
    want_paths = dict(tree.paths(want))
    got_paths = dict(tree.paths(got))
    if sorted(got_paths) != sorted(want_paths):
        raise ValueError("the two states have different leaves: "
                         f"{sorted(set(got_paths) ^ set(want_paths))}")
    for path, b in want_paths.items():
        if got_paths[path].dtype != b.dtype:
            raise ValueError(f"{path}: {got_paths[path].dtype} against "
                             f"{b.dtype}")
    return [(path, got_paths[path], b) for path, b in want_paths.items()]


def _share_outside(path, a, b, tol, steps) -> float:
    """The share of ``a``'s entries further than ``tol`` from ``b``'s (float
    leaves, bf16 as uint16 bits), but for the entries that the ``steps``
    recorded over the reference run explain as straddles
    (``TransportSteps.explained_at``; their count goes to
    ``steps.explained[path]``); 1.0 when they disagree on being finite,
    or when an entry outside lies more than ``steps.allow`` code steps
    (``TransportSteps``) beyond the tolerance."""
    a, b = _values(a), _values(b)
    diff = np.abs(a - b)
    out = ~(diff <= tol)
    if (np.isfinite(a) != np.isfinite(b)).any():
        return 1.0
    step = None if steps is None or not out.any() else \
        steps.of(path, b.size)
    if step is not None:
        bound = np.broadcast_to(tol + steps.allow * step.reshape(b.shape),
                                b.shape)
        if (diff[out] > bound[out]).any():
            return 1.0
        ok = steps.explained_at(path, b.size)
        if ok is not None:
            ok = out & ok.reshape(b.shape)
            steps.explained[path] = int(ok.sum())
            out = out & ~ok
    return float(np.mean(out))


# Under the mixed policy (bf16 working params and moments, float32
# master) a worker's inner steps compute from bf16 gradients and moments;
# an upstream last-bit difference rounds one of them one bf16 ulp (2^-8)
# the other way, and the AdamW step m̂/(√v̂ + ε) it takes moves by about
# that share of itself (at most ~2 early in training): the master moves
# by up to lr·2^-6 per step, and the async run carries it into the
# global, the outer buffers and the snapshots, arrival after arrival. So
# the float32 leaves of a mixed-policy async run are held to an extra
# absolute drift of MIXED_DRIFT_PER_STEP · inner lr per inner step the
# run took (``tests/test_torch_async.py`` reads at most a sixth of it).
MIXED_DRIFT_PER_STEP = 2.0 ** -6
# An async run applies one outer step per arrival where a round applies
# one per round; each carries the inner phase's last-bit differences (the
# matmuls' and reductions' summation orders) through the outer momentum
# into the global, so the float32 atol of a round (1e-5) is taken once per
# application (the run's ``version``): the f32 JAX parity runs of
# ``tests/test_torch_async*.py`` (six arrivals) read at most 1.17e-5.
ASYNC_ATOL_PER_APPLY = 1e-5
# Under the mixed policy the payload's upstream differences are the
# master's drift (above), not float32 last bits, so a quantized transport
# flips a code at an entry with a probability of about drift / step, far
# more often: at most this share of a leaf's entries may lie outside the
# tolerance (each still within ``TransportSteps.allow`` code steps). The
# mixed int4 JAX parity runs of ``tests/test_torch_async*.py`` read at
# most 5.0e-3.
MIXED_FLIP_SHARE = 1e-2


def async_mismatch_shares(got: dict, want: dict, *, H: int,
                          steps: TransportSteps | None = None,
                          drift: float = 0.0) -> dict:
    """For two async states in ``convert.async_state_to_numpy``'s form,
    each leaf's share of entries outside the tolerance of an async run:
    float32 leaves (global, outer buffers, snapshots, residuals, float32
    worker params, moments and masters) atol ``ASYNC_ATOL_PER_APPLY`` per
    application of the reference run (its ``counters.version``, at least
    one), rtol 1e-4; bf16 worker leaves (the mixed policy's working
    params and moments) within H bf16 ulps of the leaf's largest
    magnitude, as ``mismatch_shares``; the counters, versions and flags
    exactly. ``drift`` widens the float32 leaves' atol
    (``MIXED_DRIFT_PER_STEP``). A float leaf counts as all outside (1.0)
    when its entries disagree on being finite or, given the ``steps``
    recorded over the reference run, when an entry outside lies more than
    ``steps.allow`` code steps beyond the tolerance."""
    atol = drift + ASYNC_ATOL_PER_APPLY * max(
        1, int(want["counters"]["version"]))
    shares = {}
    for path, a, b in _paired(got, want):
        if b.dtype == np.uint16:
            tol = H * ulp_bf16(float(np.abs(_values(b)).max(initial=0.0)))
        elif b.dtype == np.float32:
            tol = atol + 1e-4 * np.abs(b)
        else:
            shares[path] = 1.0 - float(np.mean(a == b))
            continue
        shares[path] = _share_outside(path, a, b, tol, steps)
    return shares


def _stream_value_widen(path: str, widen: list):
    """For a pending, residual or in-flight payload leaf, the widening of
    its replica leaf (by path; payloads are keyed by leaf index); None for
    the other leaves (armed, masks)."""
    parts = path.split(".")
    if parts[0] in ("pending", "residual"):
        return dict(widen)[".".join(parts[1:])]
    if parts[0] == "inflight" and parts[2] == "payload":
        return widen[int(parts[3])][1]
    return None



def stream_mismatch_shares(got: dict, want: dict, *, H: int,
                           pure: bool = False,
                           steps: TransportSteps | None = None) -> dict:
    """For two states of ``convert.stream_state_to_numpy``'s form, each
    leaf's share of entries outside the round's tolerance: ``base`` as
    ``mismatch_shares``, the other float32 leaves (pending, residual,
    in-flight payloads) atol 1e-5, rtol 1e-4 (under the pure policy, whose
    deltas are taken from bf16 replicas, plus two bf16 ulps of the leaf's
    largest replica value, as ``mismatch_shares`` widens the globals'),
    the rest (armed, masks) exactly.

    A float leaf counts as all outside (share 1.0) when its entries
    disagree on being finite, or, given the ``steps`` recorded over the
    reference run, when an entry outside the tolerance lies further than
    ``steps.allow`` code steps beyond it (``TransportSteps``)."""
    pairs = _paired(got, want)
    tols = {f"base.{p}": t for p, t in _tolerances(
        want["base"], H=H, pure=pure).items()}
    widen = [(p, 2 * ulp_bf16(float(np.abs(_values(r)).max())))
             for p, r in tree.paths(want["base"]["replica_params"])]
    shares = {}
    for path, a, b in pairs:
        tol = tols.get(path)
        if not path.startswith("base.") and \
                _stream_value_widen(path, widen) is not None:
            atol = 1e-5 + (_stream_value_widen(path, widen) if pure else 0)
            tol = atol + 1e-4 * np.abs(b)
        if tol is None:
            shares[path] = 1.0 - float(np.mean(a == b))
            continue
        shares[path] = _share_outside(path, a, b, tol, steps)
    return shares


def gossip_mismatch_shares(got: dict, want: dict, *, H: int, dcfg) -> dict:
    """For two gossip states of ``convert.gossip_state_to_numpy``'s form,
    each leaf's share of entries outside the round's tolerance
    (``mismatch_shares``': float32 atol 1e-5, rtol 1e-4; bf16 policy
    leaves within H bf16 ulps; counters exactly).

    Under ``dcfg``'s bf16 exchange an upstream last-bit difference can
    round a partner's estimate to the other bf16 neighbour: the mixed
    estimate then moves by mix bf16 steps of the estimate, and the
    replica adopts it. So each entry outside the tolerance must lie
    within 1 + outer_lr·(1 + momentum) bf16 steps of the reference's
    estimate at its position beyond it (the local outer step carries a
    flip as ``TransportSteps.allow`` states), else the leaf counts as all
    outside (1.0), as it does when its entries disagree on being
    finite. A float32 exchange allows no step."""
    allow = 0.0 if dcfg.outer_grad_dtype == "float32" else 1.0 + float(
        dcfg.outer_lr) * (1.0 + float(dcfg.outer_momentum))
    tols = _tolerances(want, H=H, pure=False)
    est = {p: bf16_steps(_values(v))
           for p, v in tree.paths(want["global_est"])}
    suffixes = sorted(est, key=len, reverse=True)
    shares = {}
    for path, a, b in _paired(got, want):
        tol = tols[path]
        if tol is None:
            shares[path] = 1.0 - float(np.mean(a == b))
            continue
        a, b = _values(a), _values(b)
        diff = np.abs(a - b)
        out = ~(diff <= tol)
        step = est[next(p for p in suffixes if path.endswith("." + p))]
        if (np.isfinite(a) != np.isfinite(b)).any() or (
                diff[out] > (tol + allow * step)[out]).any():
            shares[path] = 1.0
            continue
        shares[path] = float(np.mean(out))
    return shares


# The serving path on the card against the CPU, or a batched request
# against the same request decoded alone (cuBLAS may pick another
# algorithm for another batch size): logits within this share of the
# reference's largest |logit|, and the tokens the reference's argmax
# wherever its top-2 margin is wider than that share.
SERVE_LOGIT_RTOL = 1e-4


def serve_mismatches(tokens, got_logits, ref_logits, *,
                     rtol: float = SERVE_LOGIT_RTOL,
                     forced: bool = False) -> dict:
    """Hold one request's generated ``tokens`` (n,) and the logits they
    were drawn from, ``got_logits`` (n, V), to reference logits
    ``ref_logits`` (n, V) of the same steps. ``forced``: the reference was
    fed these tokens (teacher forcing), so every step compares; else it
    chose its own, and the comparison ends at the first token where the
    two differ. A token that differs from the reference's argmax where the
    reference's top-2 margin is at most rtol·max|logit| is a near tie;
    anywhere else it is ``bad``. Returns {"steps_compared",
    "max_logit_err" (relative to the step's max|logit|), "near_ties",
    "bad" (the steps)}."""
    out = {"steps_compared": 0, "max_logit_err": 0.0, "near_ties": 0,
           "bad": []}
    for i, tok in enumerate(np.asarray(tokens)):
        ref = np.asarray(ref_logits[i], np.float64)
        scale = float(np.abs(ref).max())
        err = float(np.abs(np.asarray(got_logits[i], np.float64)
                           - ref).max()) / max(scale, 1e-30)
        out["max_logit_err"] = max(out["max_logit_err"], err)
        out["steps_compared"] += 1
        top2 = np.sort(ref)[-2:]
        if int(tok) != int(np.argmax(ref)):
            if top2[1] - top2[0] <= rtol * scale:
                out["near_ties"] += 1
            else:
                out["bad"].append(i)
            if not forced:
                break
    return out
