"""What moves the async int4 parity cases after a Join: both engines'
clipped gradients and AdamW moments at every inner step of scenario B
(``tests/test_torch_async_faults.py``), held against each other. Not a
test module; run it from the repository's root:

    PYTHONPATH=src python tests/async_join_probe.py [--ef]

It prints, per inner step, how many gradient entries differ by more than
the float32 bound of the gradient parity tests (``families_common``'s
GRAD_ATOL + GRAD_RTOL·|g|) and how many change sign; at each step from
zero moments (a dispatch or a Join), the entries whose update
lr·g/(|g| + ε) the two runs take more than 0.1·lr apart, with |g|, |Δg|,
the bound and ε; the flips that no straddle explains, each at its leaf
and entry with the Join worker's gradients and moments there; and the
counterfactual: the port's run again with JAX's gradient at those
first-step entries only, held to the standing limits
(``test_torch_async.assert_case_matches``).
"""
from __future__ import annotations

import sys

import jax
import jax.flatten_util
import numpy as np
import torch

import families_common as FC
import test_torch_async as TA
from repro.core import faults as JF
from repro.optim import adamw as jadam
from repro_torch import tree
from repro_torch.optim import adamw as tadam

EPS, B1, B2 = 1e-8, 0.9, 0.95


def _bound(g):
    return FC.GRAD_ATOL + FC.GRAD_RTOL * np.abs(g)


def record(ef: bool, fix=None):
    """Run scenario B's int4 case in both engines; returns (JAX steps,
    port steps, the port's ``TransportSteps``, and whether the case holds
    to the standing limits). Each step: (flat clipped gradient, flat m
    and v before it, count before it, lr). ``fix``: {step: {flat
    position: value}} written into the port's gradient before its
    update."""
    jrec, trec = [], []
    jupd, tupd = jadam.update, tadam.update

    def jwrap(grads, state, params, **kw):
        flat = lambda t: jax.flatten_util.ravel_pytree(t)[0]
        jax.debug.callback(
            lambda g, m, v, c, lr: jrec.append(
                (np.asarray(g), np.asarray(m), np.asarray(v), int(c),
                 float(lr))),
            flat(grads), flat(state.m), flat(state.v), state.count,
            kw["lr"], ordered=True)
        return jupd(grads, state, params, **kw)

    def twrap(grads, state, params, **kw):
        i = len(trec)
        leaves = tree.leaves(grads)
        if fix and i in fix:
            offs = np.cumsum([0] + [t.numel() for t in leaves])
            for pos, val in fix[i].items():
                li = int(np.searchsorted(offs, pos, side="right")) - 1
                leaves[li].view(-1)[pos - offs[li]] = float(val)
        flat = lambda ts: torch.cat([t.detach().float().reshape(-1)
                                     for t in ts]).numpy().copy()
        trec.append((flat(leaves), flat(tree.leaves(state.m)),
                     flat(tree.leaves(state.v)), int(state.count),
                     float(kw["lr"])))
        return tupd(grads, state, params, **kw)

    jadam.update, tadam.update = jwrap, twrap
    try:
        want, got, jhist, thist, steps = TA.run_case("B", "int4", ef, None)
        jax.effects_barrier()
    finally:
        jadam.update, tadam.update = jupd, tupd
    try:
        TA.assert_case_matches(want, got, jhist, thist, steps,
                               transport="int4")
        holds = True
    except AssertionError:
        holds = False
    return jrec, trec, steps, holds


def _leaf_of(pos, names, offs):
    li = int(np.searchsorted(offs, pos, side="right")) - 1
    return f"{names[li]}[{pos - offs[li]}]"


def main(ef: bool):
    jrec, trec, steps, holds = record(ef)
    params = TA._setup()[2]
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    offs = np.cumsum([0] + [int(np.prod(x.shape))
                            for x in jax.tree.leaves(params)])
    fields, ticks = TA.SCENARIOS["B"]
    phases = [e for e in JF.Scenario(**fields).timeline(TA.K, ticks)
              if isinstance(e, (JF.Arrival, JF.Lost))]
    print(f"scenario B, int4, error feedback {ef}: the case "
          f"{'holds' if holds else 'fails'} the standing limits")
    fix = {}
    for i, (j, t) in enumerate(zip(jrec, trec)):
        ph = phases[i // TA.H]
        gj, gt = j[0].astype(np.float64), t[0].astype(np.float64)
        dg = np.abs(gj - gt)
        line = (f"step {i:2d} ({type(ph).__name__} worker {ph.worker} uid "
                f"{ph.uid}, count {t[3]}, lr {t[4]:.6g}): "
                f"{int((dg > _bound(gj)).sum())} of {gj.size} gradient "
                f"entries beyond the bound (largest |dg| {dg.max():.3g}), "
                f"{int((np.sign(gj) != np.sign(gt)).sum())} change sign")
        print(line)
        if t[3] == 0:        # from zero moments: the update g/(|g| + eps)
            du = np.abs(gj / (np.abs(gj) + EPS) - gt / (np.abs(gt) + EPS))
            for pos in np.nonzero(du > 0.1)[0]:
                # the first-order sensitivity eps/(|g| + eps)² times the
                # bound, at each run's own g
                first = [EPS / (abs(g) + EPS) ** 2 * _bound(gj[pos])
                         for g in (gj[pos], gt[pos])]
                print(f"    {_leaf_of(pos, names, offs)}: g {gj[pos]:.4g} "
                      f"(JAX) {gt[pos]:.4g} (port), |dg| {dg[pos]:.3g}, "
                      f"bound {_bound(gj[pos]):.3g}, eps {EPS:g}: the "
                      f"updates {du[pos]:.4g}·lr apart (first-order "
                      f"bound {first[0]:.3g}·lr at JAX's g, "
                      f"{first[1]:.3g}·lr at the port's)")
                fix.setdefault(i, {})[int(pos)] = gj[pos]
    by_send = {}
    for send, _, pos, _, mine, theirs, bound, codes in steps.unexplained:
        by_send.setdefault(send, []).append((pos, mine, theirs, bound,
                                             codes))
    for send, rows in by_send.items():
        print(f"send {send}: {len(rows)} flips no straddle explains")
        for pos, mine, theirs, bound, codes in rows:
            print(f"    {_leaf_of(pos, names, offs)}: payload {mine:.5g} "
                  f"(port) {theirs:.5g} (JAX), {abs(mine - theirs):.2g} "
                  f"apart, straddle bound {bound:.2g}, {codes} code(s)")
            # the sender's last phase before this send: its gradients and
            # moments at this entry
            for i in range(len(trec)):
                if phases[i // TA.H].uid != _uid_of_send(phases, send):
                    continue
                j, t = jrec[i], trec[i]
                c = t[3] + 1
                mh = (B1 * t[1][pos] + (1 - B1) * t[0][pos]) / (1 - B1 ** c)
                vh = (B2 * t[2][pos] + (1 - B2) * t[0][pos] ** 2) / (
                    1 - B2 ** c)
                print(f"      step {i} (count {t[3]}): g {j[0][pos]:.4g} "
                      f"(JAX) {t[0][pos]:.4g} (port), |dg| "
                      f"{abs(j[0][pos] - t[0][pos]):.3g}, bound "
                      f"{_bound(j[0][pos]):.3g}; port m̂ {mh:.4g}, "
                      f"v̂ {vh:.4g}")
    if fix:
        *_, holds = record(ef, fix)
        print(f"counterfactual: JAX's gradient at the first-step entries "
              f"above ({sum(len(v) for v in fix.values())}) in the port's "
              f"run: the case {'holds' if holds else 'fails'} the "
              "standing limits")


def _uid_of_send(phases, send):
    """The uid of the arrival that made send ``send`` (sends follow the
    arrivals in order; a Lost phase sends nothing)."""
    return [p for p in phases if isinstance(p, JF.Arrival)][send].uid


if __name__ == "__main__":
    main("--ef" in sys.argv[1:])
