"""The port's serving path (``models/`` caches, ``launch/serve.py``,
``launch/batching.py``, packed int4 checkpoints) against the JAX
package's, on the diloco_150m smoke config with window 0 and 32, from
JAX params handed over by ``convert``: prefill and decode logits (a
decode step of each package from one cache, contiguous and paged),
``paged_kv_update``, greedy tokens at temperature 0, and the packed
buffers byte for byte. Then the port's counterparts of
``tests/test_batching.py``: continuous batching equals decoding each
request alone and the paged layout equals the contiguous one, bit for
bit; ``max_new=1``; a deferred long prompt; drain order; the first token
under temperature; packed weights close to f32; slot refill.

Tolerance on logits and caches: atol 1e-5, rtol 1e-4 (the matmuls round
their last bits apart in the two libraries); tokens, positions and
packed bytes exactly."""
from __future__ import annotations

import functools
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jck  # noqa: E402
from repro.launch.serve import greedy_decode as jgreedy  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import check, convert, tree  # noqa: E402
from repro_torch.checkpoint import checkpoint as tck  # noqa: E402
from repro_torch.launch.batching import ContinuousBatcher  # noqa: E402
from repro_torch.launch.serve import forced_logits, greedy_decode  # noqa: E402,E501
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _archs(window=0):
    """(JAX arch, port arch, JAX params, port params) of the smoke
    config, the port's params the JAX ones."""
    ja = jreg.get_smoke_arch("diloco_150m")
    ta = treg.get_smoke_arch("diloco_150m")
    if window:
        ja = jreg.Arch(cfg=ja.cfg.replace(window=window))
        ta = treg.Arch(cfg=ta.cfg.replace(window=window))
    params, _ = ja.init(jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                   device="cpu")
    return ja, ta, params, tp


def _prompts(n, lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, L).astype(np.int32) for L in lengths]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_cache(got_t, want_j):
    got = dict(tree.paths(convert.cache_to_numpy(got_t)))
    want = dict(tree.paths(jax.tree.map(np.asarray, want_j)))
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype, path
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, want[path], err_msg=path)
        else:
            _close(a, want[path], path)


@pytest.mark.parametrize("window", [0, 32])
def test_prefill_and_decode_match_jax(window):
    """Prefill builds the JAX cache; a decode step of each package from
    the JAX cache gives the same logits and cache (past the ring's wrap
    at window 32)."""
    ja, ta, params, tp = _archs(window)
    toks = np.stack(_prompts(2, [40, 40]))
    jl, jc = ja.prefill(params, {"tokens": jnp.asarray(toks)},
                        cache_len=48)
    with torch.no_grad():
        tl, tc = ta.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                            cache_len=48)
    _close(tl, jl, "prefill logits")
    _assert_cache(tc, jc)
    nxt = np.array([[3], [250]], np.int32)
    for step in range(2):
        tc = convert.cache_from_numpy(jax.tree.map(np.asarray, jc),
                                      device="cpu")
        jl, jc = ja.decode(params, jc, jnp.asarray(nxt),
                           jnp.asarray(40 + step, jnp.int32))
        with torch.no_grad():
            tl, tc = ta.decode(tp, tc, torch.from_numpy(nxt).long(),
                               40 + step)
        _close(tl, jl, f"decode {step} logits")
        _assert_cache(tc, jc)


def _paged_case(seed=0):
    """A pool with stale contents, a page table with unmapped pages and
    a ring that wraps, as JAX and port inputs."""
    rng = np.random.default_rng(seed)
    n_pages, ps, G, hd, B, pps = 7, 4, 2, 8, 3, 3
    cache = {"kp": rng.normal(size=(n_pages, ps, G, hd)).astype(np.float32),
             "vp": rng.normal(size=(n_pages, ps, G, hd)).astype(np.float32),
             "posp": rng.integers(-1, 30, (n_pages, ps)).astype(np.int32)}
    table = np.array([[2, 0, -1], [5, -1, 6], [-1, -1, -1]], np.int32)
    return cache, table, rng, (B, G, hd, ps, pps)


@pytest.mark.parametrize("S,pos", [(1, 9), (5, 10), (14, 3)])
def test_paged_kv_update_matches_jax(S, pos):
    cache, table, rng, (B, G, hd, ps, pps) = _paged_case(S)
    k = rng.normal(size=(B, S, G, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, G, hd)).astype(np.float32)
    jc, jk, jv, jp = JL.paged_kv_update(
        jax.tree.map(jnp.asarray, cache), jnp.asarray(table),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32))
    tc = convert.cache_from_numpy(cache, device="cpu")
    tc, tk, tv, tp = TL.paged_kv_update(tc, table, torch.from_numpy(k),
                                        torch.from_numpy(v), pos)
    for got, want in ((tk, jk), (tv, jv), (tp, jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_cache(tc, jc)


@pytest.mark.parametrize("window", [0, 32])
def test_paged_decode_matches_jax(window):
    """A paged prefill and decode step of each package from one pool."""
    ja, ta, params, tp = _archs(window)
    C, ps = 48 if not window else 32, 16
    jcache = JM.init_paged_cache(ja.cfg, 2, 48, jnp.float32, page_size=ps,
                                 n_pages=7, window=window)
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    table = np.array([[4, 0, 6][:C // ps], [1, 5, -1][:C // ps]], np.int32)
    toks = np.stack(_prompts(2, [20, 20], seed=4))
    jl, jcache, _ = JM.forward(params, ja.cfg, jnp.asarray(toks),
                               cache=jcache,
                               cache_pos=jnp.asarray(3, jnp.int32),
                               window=window or None,
                               page_table=jnp.asarray(table))
    with torch.no_grad():
        tl, tcache, _ = TM.forward(tp, ta.cfg, torch.from_numpy(toks).long(),
                                   cache=tcache, cache_pos=3,
                                   window=window or None, page_table=table)
    _close(tl, jl, "paged prefill")
    _assert_cache(tcache, jcache)
    nxt = np.array([[7], [9]], np.int32)
    jl, jcache = JM.decode_step(params, ja.cfg, jcache, jnp.asarray(nxt),
                                jnp.asarray(23, jnp.int32), window=window,
                                page_table=jnp.asarray(table))
    with torch.no_grad():
        tl, tcache = TM.decode_step(tp, ta.cfg, tcache,
                                    torch.from_numpy(nxt).long(), 23,
                                    window=window, page_table=table)
    _close(tl, jl, "paged decode")
    _assert_cache(tcache, jcache)


@pytest.mark.parametrize("window", [0, 32])
def test_greedy_tokens_equal_jax(window):
    ja, ta, params, tp = _archs(window)
    prompts = np.stack(_prompts(3, [24, 24, 24], seed=5))
    want = np.asarray(jgreedy(ja, params, jnp.asarray(prompts), gen=20))
    got = greedy_decode(ta, tp, prompts, gen=20).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_buffers_equal_jax(tmp_path):
    """save_packed writes JAX's buffers and manifest byte for byte; each
    package restores the other's file; restore_packed = unpack_params."""
    ja, ta, params, tp = _archs()
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jman = jck.save_packed(jpath, params, n_fragments=4)
    tman = tck.save_packed(tpath, tp, n_fragments=4)
    assert tman == jman
    jb, tb = jck.load_packed(jpath), tck.load_packed(tpath)
    assert tb["manifest"] == jb["manifest"]
    assert sorted(tb["buffers"]) == sorted(jb["buffers"])
    for key in jb["buffers"]:
        assert tb["buffers"][key].dtype == np.uint8
        assert tb["buffers"][key].tobytes() == jb["buffers"][key].tobytes()
    unpacked = tck.unpack_params(
        {k: torch.from_numpy(v) for k, v in tb["buffers"].items()},
        tb["manifest"], tp)
    for path in (jpath, tpath):
        got = tck.restore_packed(path, tp)
        for a, b in zip(tree.leaves(got), tree.leaves(unpacked)):
            assert torch.equal(a, b)
    jr = jck.restore_packed(tpath, params)
    for a, b in zip(jax.tree.leaves(jr), tree.leaves(unpacked)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---- the port's counterparts of tests/test_batching.py ----

def _isolated(ta, tp, prompt, gen):
    return greedy_decode(ta, tp, np.asarray(prompt)[None],
                         gen=gen).numpy()[0]


@pytest.mark.parametrize("window", [0, 32])
def test_continuous_matches_isolated_and_paged_matches_contiguous(window):
    _, ta, _, tp = _archs(window)
    prompts = _prompts(4, [12, 7, 19, 5], seed=2)
    gens = [6, 1, 4, 8]                  # includes the max_new=1 edge
    outs = {}
    for paged in (False, True):
        eng = ContinuousBatcher(ta, tp, slots=2, cache_len=96, paged=paged,
                                page_size=16)
        rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        done = eng.run_until_drained()
        outs[paged] = [done[r] for r in rids]
        assert eng.decode_steps > 0 and eng.prefills == 4
    for c, p in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(c, p)
    for out, p, g in zip(outs[True], prompts, gens):
        np.testing.assert_array_equal(out, _isolated(ta, tp, p, g))


@pytest.mark.parametrize("paged", [False, True])
def test_max_new_one_generates_exactly_one(paged):
    _, ta, _, tp = _archs()
    eng = ContinuousBatcher(ta, tp, slots=2, cache_len=64, paged=paged)
    prompt = np.arange(6)
    rid = eng.submit(prompt, 1)
    out = eng.run_until_drained()
    assert len(out[rid]) == 1
    np.testing.assert_array_equal(out[rid], _isolated(ta, tp, prompt, 1))


@pytest.mark.parametrize("paged", [False, True])
def test_long_prompt_deferred_keeps_incumbent_exact(paged):
    """A prompt longer than the clock waits until the clock reaches it,
    overlaps the incumbent, and leaves its tokens untouched."""
    _, ta, _, tp = _archs()
    eng = ContinuousBatcher(ta, tp, slots=2, cache_len=96, paged=paged)
    short = np.arange(6) % 256
    long_ = (np.arange(20) * 3) % 256
    r_short = eng.submit(short, 30)
    r_long = eng.submit(long_, 4)
    for _ in range(100):
        eng.tick()
        if r_long in eng.finished:
            break
    assert r_long in eng.finished
    assert r_short not in eng.finished
    out = eng.run_until_drained()
    np.testing.assert_array_equal(out[r_short],
                                  _isolated(ta, tp, short, 30))
    np.testing.assert_array_equal(out[r_long], _isolated(ta, tp, long_, 4))


def test_drain_order_many_requests_two_slots():
    _, ta, _, tp = _archs()
    prompts = _prompts(6, [9, 4, 16, 6, 11, 5], seed=3)
    gens = [3, 7, 2, 5, 1, 4]
    eng = ContinuousBatcher(ta, tp, slots=2, cache_len=96)
    rids = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    out = eng.run_until_drained()
    assert set(out) == set(rids)
    for rid, p, g in zip(rids, prompts, gens):
        np.testing.assert_array_equal(out[rid], _isolated(ta, tp, p, g))


def test_first_token_respects_temperature():
    _, ta, _, tp = _archs()
    prompts = np.arange(4 * 8).reshape(4, 8) % 256
    cold = greedy_decode(ta, tp, prompts, gen=2).numpy()
    firsts = [greedy_decode(ta, tp, prompts, gen=2, temperature=5.0,
                            seed=s).numpy()[:, 0] for s in range(6)]
    assert any(not np.array_equal(f, cold[:, 0]) for f in firsts)
    assert any(not np.array_equal(firsts[0], f) for f in firsts[1:])
    np.testing.assert_array_equal(
        cold, greedy_decode(ta, tp, prompts, gen=2).numpy())
    # the engine samples from its own seeded generator: one seed, one run
    runs = []
    for _ in range(2):
        eng = ContinuousBatcher(ta, tp, slots=2, cache_len=32,
                                temperature=5.0, seed=3)
        rid = eng.submit(prompts[0], 5)
        runs.append(eng.run_until_drained()[rid])
    np.testing.assert_array_equal(runs[0], runs[1])


def test_packed_int4_weights_serve_close_to_f32(tmp_path):
    """int4 packed-weight serving: prefill logits within the JAX test's
    bound of f32 (0.15·max|logit| + 0.05); the packed engine's tokens are
    those of the engine on the unpacked weights, and every forward
    decodes them (regions × forwards wire decodes)."""
    _, ta, _, tp = _archs()
    path = str(tmp_path / "w.packed.npz")
    man = tck.save_packed(path, tp, n_fragments=4)
    assert man["f32_bytes"] / man["packed_bytes"] > 5.0
    packed = tck.load_packed(path)
    deq = tck.unpack_params(
        {k: torch.from_numpy(v) for k, v in packed["buffers"].items()},
        packed["manifest"], tp)
    toks = torch.from_numpy(np.arange(2 * 12).reshape(2, 12) % 256)
    with torch.no_grad():
        lf, _ = ta.prefill(tp, {"tokens": toks}, cache_len=16)
        lq, _ = ta.prefill(deq, {"tokens": toks}, cache_len=16)
    scale = float(lf.abs().max())
    assert float((lf - lq).abs().max()) <= 0.15 * scale + 0.05
    outs = []
    for weights in ("packed", "f32"):
        eng = ContinuousBatcher(
            ta, tp if weights == "packed" else deq, slots=2, cache_len=64,
            packed_weights=packed if weights == "packed" else None,
            device="cpu")
        rids = [eng.submit(np.arange(5 + i) % 256, 4) for i in range(3)]
        out = eng.run_until_drained()
        assert set(out) == set(rids)
        outs.append([out[r] for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(ta, tp, slots=2, cache_len=64, paged=False,
                          packed_weights=packed)


def test_slots_refill_as_requests_finish():
    """Five requests through two slots: a slot freed in one tick takes the
    next queued request in the next tick (every request here runs at
    least two ticks, so it is still there after it), and the pages of a
    finished request return to the pool."""
    _, ta, _, tp = _archs()
    eng = ContinuousBatcher(ta, tp, slots=2, cache_len=64, page_size=16)
    # one prompt length: no request waits for the clock
    rids = [eng.submit((np.arange(4) + i) % 256, 3 + i) for i in range(5)]
    refills = 0
    while eng.queue:
        before = [None if r is None else r.rid for r in eng.active]
        queued = eng.queue[0].rid
        eng.tick()
        for i, rid in enumerate(before):
            if rid is None and eng.active[i] is not None:
                assert eng.active[i].rid >= queued
                refills += 1
            elif rid is None:
                raise AssertionError(f"slot {i} stayed free")
    assert refills == 5 and eng.prefills == 5
    out = eng.run_until_drained()
    assert [len(out[r]) for r in rids] == [3, 4, 5, 6, 7]
    assert len(eng.free_pages) == eng.n_pages
    assert (eng.table == -1).all()


def test_recorded_logits_are_those_of_the_request_alone():
    """The engine's recorded logits of a batched request against the same
    request decoded alone (teacher-forced on its tokens): within
    ``check.SERVE_LOGIT_RTOL``, every token the argmax."""
    _, ta, _, tp = _archs(32)
    prompts = _prompts(3, [20, 9, 14], seed=6)
    eng = ContinuousBatcher(ta, tp, slots=2, cache_len=64,
                            record_logits=(0, 2))
    rids = [eng.submit(p, 12) for p in prompts]
    out = eng.run_until_drained()
    assert sorted(eng.logits) == [0, 2]
    for rid in (0, 2):
        got = torch.stack(eng.logits[rid])
        assert got.shape == (12, 256)
        ref = forced_logits(ta, tp, prompts[rid], out[rids[rid]])
        res = check.serve_mismatches(out[rids[rid]], got, ref, forced=True)
        assert res["bad"] == [] and res["near_ties"] == 0
        assert res["steps_compared"] == 12
        assert res["max_logit_err"] <= check.SERVE_LOGIT_RTOL


def test_unpacking_leaves_no_reference_cycles():
    """A packed engine's tick frees every tensor it made when it returns:
    no reference cycle keeps a decoded weight tree alive until Python's
    cycle collector runs (on the card each tree is the whole model)."""
    _, ta, _, tp = _archs()
    path = None
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/w.npz"
        tck.save_packed(path, tp)
        packed = tck.load_packed(path)
    eng = ContinuousBatcher(ta, tp, slots=2, cache_len=64,
                            packed_weights=packed)
    for n in (10, 12):
        eng.submit(np.arange(n) % 256, 6)
    eng.tick()
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        eng.tick()
        gc.collect()
        leaked = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert leaked == []
