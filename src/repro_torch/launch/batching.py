"""Continuous batching for the serving path (the JAX ``launch/batching.py``).

A vLLM-style slot scheduler on top of the model's prefill and decode
entry points: a fixed pool of B slots decodes in ONE batched
``decode_step`` per tick; finished slots are refilled from the request
queue without stalling the others.

All slots share one clock ``t``. A request with prompt length L admitted
at tick t is prefilled at absolute positions [t−L, t): RoPE and the
sliding-window mask depend only on relative positions, so each request's
logits are those of running it alone. The per-slot position tracks (-1 =
empty) keep a fresh request from attending to its slot's previous
occupant. The clock only jumps forward (to fit a long prompt) while NO
slot is active: a jump mid-run would open a position gap in every
incumbent's ring, so a too-long prompt is deferred until the advancing
clock reaches it.

Two cache layouts behind the same scheduler:

  contiguous (paged=False)  every slot owns a full (C,)-long ring row;
      admission resets the slot's rows and prefills into them in place.
  paged (paged=True, the default)  fixed-size pages in ONE shared pool
      per layer group and a per-slot page table on the host
      (``models/model.py`` ``init_paged_cache``): a short request occupies
      only the pages its positions touch; admission maps pages, clears
      their position tracks and prefills straight into the pool. The
      tokens equal the contiguous layout's bit for bit (the gathered
      dense view is the same ring).

In both, every per-slot leaf (the SSM and xLSTM states, MLA latent rings,
cross K/V) is reset at admission to its ``init_cache`` value (the xLSTM
stabilisers to −1e30, not 0). The VLM and encoder-decoder families are
refused: a request is a prompt, with no modality input.

There is no compiled step to copy: each tick is a plain eager decode
that writes the cache in place, then the sampling, and the host waits
once per tick, for the (B,) sampled tokens; the host-side inputs (tokens,
page indices) reach the card from pinned memory without a wait. With
``packed_weights`` (``checkpoint.load_packed``) the weights stay packed
int4 on the device and every forward decodes them (``checkpoint.
unpack_params``: one ``unpack_dequantize_int4`` launch a region on the
card); ``decode_steps`` and ``prefills`` count those forwards.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tree
from ..checkpoint import checkpoint as ckpt
from ..models import layers as L
from ..models import model as M


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int64
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False
    submit_tick: int = -1
    finish_tick: int = -1


class ContinuousBatcher:
    """Slot-based continuous batching engine.

    engine = ContinuousBatcher(arch, params, slots=4, cache_len=256)
    engine.submit(prompt_tokens, max_new=32) -> rid
    engine.run_until_drained() -> {rid: np.ndarray(generated)}

    ``paged=True`` (the default) uses the paged KV cache; ``page_size``
    must divide the effective ring length, ``n_pages`` defaults to full
    provisioning (slots · pages_per_slot: admission never waits).
    ``packed_weights`` (a ``checkpoint.load_packed`` result) serves int4
    weights decoded at every forward (paged mode only, as in the JAX
    engine); ``params`` then supplies only structure and shapes (tensors
    on the ``meta`` device do) and ``device`` says where to serve.
    Sampling at ``temperature`` > 0 draws from a ``torch.Generator`` on
    the device seeded with ``seed`` (the JAX engine's ``jax.random``
    draws cannot be reproduced). ``record_logits``: request ids whose
    logits, one (V,) row per generated token, the engine copies to the
    host into ``logits`` (one more wait per tick: for checks, not for
    serving)."""

    def __init__(self, arch, params, *, slots: int, cache_len: int,
                 temperature: float = 0.0, seed: int = 0,
                 paged: bool = True, page_size: int = 16,
                 n_pages: int | None = None, packed_weights=None,
                 device=None, record_logits=()):
        self.arch = arch
        self.cfg = arch.cfg
        if self.cfg.pos_emb == "learned":
            raise ValueError(
                "continuous batching requires translation-invariant "
                "positions (rope/none); learned absolute embeddings "
                "break the shared-clock alignment")
        cross = M.make_plan(self.cfg).cross_src
        if cross:
            raise ValueError(
                f"continuous batching takes no {cross!r} input (submit "
                f"takes a prompt only): serve the {self.cfg.family} family "
                "through launch/serve.py's greedy_decode")
        self.device = torch.device(
            device if device is not None else tree.leaves(params)[0].device)
        if self.device.type == "meta":
            raise ValueError("params on the meta device: pass device=")
        self.B = slots
        self.C = cache_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.queue: collections.deque[Request] = collections.deque()
        self.active: list[Request | None] = [None] * slots
        self.remaining = np.zeros(slots, np.int64)
        self.last_tok = np.zeros(slots, np.int64)
        self._next_rid = 0
        self.clock = 0
        self.ticks = 0
        self.decode_steps = 0          # batched decodes run
        self.prefills = 0              # admissions' prompt forwards run
        self.timing = {"prefill_s": [], "decode_s": []}
        self.record_logits = set(record_logits)
        self.logits: dict[int, list] = {}
        self.paged = paged
        # the effective attention-ring length (windowed configs cap it)
        self.C_eff = min(cache_len, self.cfg.window) \
            if self.cfg.window else cache_len

        if packed_weights is not None and not paged:
            raise ValueError("packed int4 weight serving requires the "
                             "paged engine")
        if packed_weights is not None:
            man = packed_weights["manifest"]
            example = tree.map(
                lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
                params)
            self._weights = {k: torch.from_numpy(np.asarray(v))
                             .to(self.device)
                             for k, v in packed_weights["buffers"].items()}
            self._make_params = lambda w: ckpt.unpack_params(
                w, man, example)
        else:
            self._weights = params
            self._make_params = lambda w: w

        if paged:
            self.page_size = page_size
            if self.C_eff % page_size:
                raise ValueError(
                    f"cache_len (effective {self.C_eff}) must be a "
                    f"multiple of page_size={page_size}")
            self.pages_per_slot = self.C_eff // page_size
            self.n_pages = n_pages or slots * self.pages_per_slot
            self.cache = M.init_paged_cache(
                self.cfg, slots, cache_len, torch.float32,
                page_size=page_size, n_pages=self.n_pages,
                window=self.cfg.window, device=self.device)
            self.table = np.full((slots, self.pages_per_slot), -1,
                                 np.int32)
            self.free_pages: collections.deque[int] = collections.deque(
                range(self.n_pages))
            self.slot_pages: list[list[int]] = [[] for _ in range(slots)]
        else:
            self.cache = M.init_cache(self.cfg, slots, cache_len,
                                      torch.float32, window=self.cfg.window,
                                      device=self.device)
        # one empty row of every per-slot leaf, as ``init_cache`` makes it
        # (zeros, -1 position tracks, the xLSTM stabilisers at -1e30): an
        # admission resets its slot's rows to it
        self._blank = M.init_cache(self.cfg, 1, cache_len, torch.float32,
                                   window=self.cfg.window,
                                   device=self.device)
        self.finished: dict[int, np.ndarray] = {}
        self.latencies: dict[int, int] = {}      # rid -> ticks-to-finish

    # ---- public API ----
    def submit(self, prompt, max_new: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        if self.paged:
            # worst-case alignment: an unaligned start straddles one extra
            # page. Deferring such a request would deadlock: refuse it
            need = self._pages_for_span(self.page_size - 1,
                                        len(prompt) + max_new)
            if len(need) > self.n_pages:
                raise ValueError(
                    f"request spans {len(need)} pages but the pool has "
                    f"{self.n_pages}; raise n_pages or cache_len")
        self.queue.append(Request(rid, np.asarray(prompt, np.int64),
                                  max_new, submit_tick=self.ticks))
        return rid

    def run_until_drained(self, max_ticks: int = 100_000):
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.active):
                break
            self.tick()
        return dict(self.finished)

    # ---- sampling ----
    def _sample(self, logits):
        """(B,) tokens of (B, V) logits: argmax at temperature 0, else a
        draw from the engine's generator."""
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, -1)
            return torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.argmax(logits, -1)

    def _tokens(self, toks) -> torch.Tensor:
        return L._on(np.asarray(toks, np.int64), self.device)

    def _slot_row(self, slot: int):
        """The cache as slot ``slot`` sees it: every per-slot leaf's row
        (a view: writes land in the cache), the shared page pools whole;
        each per-slot row reset to its empty value first."""
        def row(path, a):
            if path and path[-1] in M.PAGED_LEAF_NAMES:
                return a
            r = a[:, slot:slot + 1]
            r.copy_(blank[path])
            return r

        blank = {tuple(e[1] for e in p): a
                 for p, a in tree.flatten_with_path(self._blank)}
        return _map_with_path(row, self.cache)

    # ---- contiguous admission (the slot's rows, in place) ----
    def _admit_contiguous(self, slot: int, req: Request):
        start = self.clock - len(req.prompt)     # prompt at [t-L, t)
        assert start >= 0, "advance the clock before admitting"
        row = self._slot_row(slot)
        logits, _, _ = M.forward(
            self._make_params(self._weights), self.cfg,
            self._tokens(req.prompt)[None], cache=row, cache_pos=start,
            window=self.cfg.window or None)
        return logits[:, -1]

    # ---- paged admission (page-table edit + prefill into the pool) ----
    def _pages_for_span(self, start: int, span: int) -> list[int]:
        """Logical ring pages touched by positions [start, start+span)."""
        C, ps = self.C_eff, self.page_size
        if span >= C:
            return list(range(self.pages_per_slot))
        pages, seen = [], set()
        for p in range(start, start + span):
            lp = (p % C) // ps
            if lp not in seen:
                seen.add(lp)
                pages.append(lp)
        return pages

    def _free_slot_pages(self, slot: int):
        for pg in self.slot_pages[slot]:
            self.free_pages.append(pg)
        self.slot_pages[slot] = []
        self.table[slot] = -1

    def _admit_paged(self, slot: int, req: Request):
        """Map pages, clear their position tracks and prefill into the
        pool. Returns the (1, V) last-position logits, or None if the pool
        lacks free pages right now."""
        L_ = len(req.prompt)
        start = self.clock - L_
        assert start >= 0, "advance the clock before admitting"
        lps = self._pages_for_span(start, L_ + req.max_new)
        if len(lps) > len(self.free_pages):
            return None
        new_pages = [self.free_pages.popleft() for _ in lps]
        self.slot_pages[slot] = list(new_pages)
        self.table[slot] = -1
        self.table[slot, lps] = new_pages
        reset = self._tokens(new_pages)
        for c in self.cache.values():
            if "attn" in c:
                c["attn"]["posp"].index_fill_(1, reset, -1)   # reused pages
        logits, _, _ = M.forward(
            self._make_params(self._weights), self.cfg,
            self._tokens(req.prompt)[None], cache=self._slot_row(slot),
            cache_pos=start, window=self.cfg.window or None,
            page_table=self.table[slot:slot + 1])
        return logits[:, -1]

    # ---- slot lifecycle ----
    def _finish(self, slot: int):
        req = self.active[slot]
        req.done = True
        req.finish_tick = self.ticks
        self.finished[req.rid] = np.asarray(req.out, np.int64)
        self.latencies[req.rid] = max(req.finish_tick - req.submit_tick, 1)
        self.active[slot] = None
        if self.paged:
            self._free_slot_pages(slot)

    @torch.no_grad()
    def tick(self):
        # 1. admit pending requests into free slots. The clock may only
        #    jump while NOTHING is active; too-long prompts are deferred
        #    until the clock (one per tick) catches up. First fit among
        #    the admissible keeps short requests flowing past a deferred
        #    long one.
        for i in range(self.B):
            if self.active[i] is not None or not self.queue:
                continue
            any_active = any(r is not None for r in self.active)
            pick = None
            for qi, req in enumerate(self.queue):
                if any_active and len(req.prompt) > self.clock:
                    continue               # would need a clock jump
                pick = qi
                break
            if pick is None:
                break
            req = self.queue[pick]
            if len(req.prompt) > self.clock:
                self.clock = len(req.prompt)   # warm-up: the pool is idle
            t0 = time.perf_counter()
            if self.paged:
                logits_last = self._admit_paged(i, req)
                if logits_last is None:    # pool full: retry next tick
                    break
                del self.queue[pick]
            else:
                del self.queue[pick]
                logits_last = self._admit_contiguous(i, req)
            self.prefills += 1
            self.active[i] = req
            self.remaining[i] = req.max_new
            first = int(self._sample(logits_last)[0])   # waits for it
            if req.rid in self.record_logits:
                self.logits[req.rid] = [logits_last[0].cpu()]
            self.timing["prefill_s"].append(time.perf_counter() - t0)
            self.last_tok[i] = first
            req.out.append(first)
            self.remaining[i] -= 1
            # a max_new=1 request is done after its prefill token
            if self.remaining[i] <= 0:
                self._finish(i)
        if all(r is None for r in self.active):
            self.ticks += 1
            return
        # 2. one batched decode + sample for every slot (empty slots
        #    decode garbage, masked by their position tracks or dropped by
        #    their unmapped page tables, and are discarded below)
        t0 = time.perf_counter()
        logits, self.cache = M.decode_step(
            self._make_params(self._weights), self.cfg, self.cache,
            self._tokens(self.last_tok)[:, None], self.clock,
            window=self.cfg.window,
            page_table=self.table if self.paged else None)
        nxt = self._sample(logits[:, -1]).cpu().numpy()  # the one wait
        self.timing["decode_s"].append(time.perf_counter() - t0)
        for i, req in enumerate(self.active if self.record_logits else ()):
            if req is not None and req.rid in self.record_logits:
                self.logits[req.rid].append(logits[i, -1].cpu())
        self.decode_steps += 1
        self.clock += 1
        self.ticks += 1
        # 3. bookkeeping per slot
        for i in range(self.B):
            req = self.active[i]
            if req is None:
                continue
            self.last_tok[i] = int(nxt[i])
            req.out.append(int(nxt[i]))
            self.remaining[i] -= 1
            if self.remaining[i] <= 0:
                self._finish(i)

    @property
    def utilization(self) -> float:
        return sum(r is not None for r in self.active) / self.B


def _map_with_path(fn, t, path=()):
    """``fn(path, leaf)`` over a cache tree (dicts and the recurrent
    states' tuples), ``path`` the tuple of dict keys and tuple indices."""
    if isinstance(t, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_map_with_path(fn, v, path + (i,))
                     for i, v in enumerate(t))
    return fn(path, t)
