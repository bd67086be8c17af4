"""Deterministic synthetic LM data: per-shard Markov-mixture streams (the
JAX ``data/pipeline.py``), with the chain logits on the device.

  - A base transition matrix T0 (seeded) shared by all shards.
  - Per-shard perturbations P_i; shard i samples from
    softmax(T0 + alpha * P_i). alpha=0 -> i.i.d.; alpha>0 -> non-i.i.d.
  - The validation stream samples from the *mixture* over shards.

The transition logits come from numpy ``default_rng(seed)`` in the
reference's draw order, so they equal the JAX package's bit for bit. At
the paper's vocab (32000) one (V, V) float64 draw is 8.2 GB, so the
draws are taken in row chunks from the one generator (consecutive draws
continue the same stream), cast to float32 and moved to the device
chunk by chunk; the mixture is a running sum over shards, row chunk by
row chunk (``regroup`` builds its group mixtures the same way). Tokens
are sampled on the device from a ``torch.Generator`` (the port cannot
reproduce ``jax.random``; parity tests feed both packages the JAX
sampler's tokens).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

_CHUNK_ELEMS = 1 << 24       # normals per host draw: 128 MiB of float64


class MarkovMixture:
    """Batch sampler over k shard distributions; logits on ``device``."""

    def __init__(self, vocab_size: int = 256, k: int = 8,
                 alpha: float = 2.0, seed: int = 0,
                 shard_sizes: np.ndarray | None = None, *, device,
                 chunk_rows: int = 0):
        V = self.vocab_size = vocab_size
        self.k = k
        self.alpha = float(alpha)
        self.device = torch.device(device)
        rows = chunk_rows or max(1, _CHUNK_ELEMS // V)
        rng = np.random.default_rng(seed)

        def draw(n):
            x = rng.normal(size=(n, V)).astype(np.float32)
            return torch.from_numpy(x).to(self.device)

        chunks = [(r0, min(rows, V - r0)) for r0 in range(0, V, rows)]
        base = torch.empty((V, V), dtype=torch.float32, device=self.device)
        for r0, n in chunks:
            base[r0:r0 + n] = draw(n)
        # logits: (k, V, V); shard i transition logits, in the reference's
        # float32 arithmetic: base + alpha * pert
        alpha32 = float(np.float32(self.alpha))
        self._logits = torch.empty((k, V, V), dtype=torch.float32,
                                   device=self.device)
        for i in range(k):
            for r0, n in chunks:
                self._logits[i, r0:r0 + n] = base[r0:r0 + n] \
                    + alpha32 * draw(n)
        del base
        # mixture (validation) logits: log of the mean shard probability
        self._mix_logits = torch.empty((V, V), dtype=torch.float32,
                                       device=self.device)
        for r0, n in chunks:
            acc = torch.zeros((n, V), dtype=torch.float32,
                              device=self.device)
            for i in range(k):
                acc += torch.softmax(self._logits[i, r0:r0 + n], dim=-1)
            self._mix_logits[r0:r0 + n] = torch.log(acc / k + 1e-9)
        # the card's index too: a process handed these tables (CUDA IPC)
        # may have another current card
        self.device = self._logits.device
        if shard_sizes is None:
            shard_sizes = np.ones((k,), np.float32)
        self.shard_sizes = np.asarray(shard_sizes, np.float32)

    def to(self, device) -> "MarkovMixture":
        """This sampler with its logits copied to ``device`` (itself when
        they lie there already)."""
        device = _resolved(torch.device(device))
        if device == self.device:
            return self
        out = object.__new__(MarkovMixture)
        out.__dict__.update(self.__dict__, device=device,
                            _logits=self._logits.to(device),
                            _mix_logits=self._mix_logits.to(device))
        return out

    # ---- sampling ----
    def sample_shard(self, gen, shard_id: int, batch: int, seq_len: int):
        """tokens (batch, seq_len) int64 from shard ``shard_id``'s chain
        (one async worker's batch)."""
        logits = self._logits[shard_id]
        return _sample_chain(gen, lambda tok: logits[tok], (batch,),
                             seq_len, self.vocab_size, self.device)

    def sample_all_shards(self, gen, batch: int, seq_len: int):
        """tokens (k, batch, seq_len) int64: one batch per shard."""
        shard = torch.arange(self.k, device=self.device)[:, None]
        return _sample_chain(gen, lambda tok: self._logits[shard, tok],
                             (self.k, batch), seq_len, self.vocab_size,
                             self.device)

    def sample_validation(self, gen, batch: int, seq_len: int):
        """tokens (batch, seq_len) int64 from the mixture chain."""
        return _sample_chain(gen, lambda tok: self._mix_logits[tok],
                             (batch,), seq_len, self.vocab_size,
                             self.device)

    # ---- resharding ----
    def regroup(self, k_workers: int) -> "MarkovMixture":
        """This mixture's k shards redistributed among ``k_workers``
        (round-robin), holding the data-generating process fixed, as the
        JAX ``regroup``: worker i samples from the probability mixture of
        shards i, i + k_workers, ...: its logits are log(mean of their
        softmaxes + 1e-9), its shard size their sum; the validation
        mixture is unchanged. Computed on the device row chunk by row
        chunk, so that no (k, V, V) softmax is ever held."""
        if not 1 <= k_workers <= self.k:
            raise ValueError(f"k_workers must be in [1, {self.k}], got "
                             f"{k_workers}")
        V = self.vocab_size
        rows = max(1, _CHUNK_ELEMS // V)
        logits = torch.empty((k_workers, V, V), dtype=torch.float32,
                             device=self.device)
        sizes = []
        for i in range(k_workers):
            idx = list(range(i, self.k, k_workers))
            for r0 in range(0, V, rows):
                acc = torch.zeros((min(rows, V - r0), V),
                                  dtype=torch.float32, device=self.device)
                for j in idx:
                    acc += torch.softmax(self._logits[j, r0:r0 + rows],
                                         dim=-1)
                logits[i, r0:r0 + rows] = torch.log(acc / len(idx) + 1e-9)
            sizes.append(float(self.shard_sizes[idx].sum()))
        new = copy.copy(self)
        new.k = k_workers
        new._logits = logits
        new.shard_sizes = np.asarray(sizes, np.float32)
        return new

    # ---- statistics ----
    def entropy_floor(self) -> float:
        """Per-token entropy (nats) of the mixture chain = best achievable
        validation loss; exp() of it is the perplexity floor."""
        V = self.vocab_size
        p = torch.softmax(self._mix_logits, dim=-1)
        pi = torch.full((V,), 1.0 / V, dtype=torch.float32,
                        device=self.device)
        for _ in range(64):
            pi = pi @ p
        rows = max(1, _CHUNK_ELEMS // V)
        ent = torch.zeros((), dtype=torch.float32, device=self.device)
        for r0 in range(0, V, rows):
            pr = p[r0:r0 + rows]
            ent += torch.sum(pi[r0:r0 + rows, None] * pr
                             * torch.log(pr + 1e-12))
        return float(-ent)


def _resolved(device: torch.device) -> torch.device:
    """``device`` with the current card's index when it names none."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _sample_chain(gen, rows_of, lead, seq_len: int, vocab: int, device):
    """First tokens uniform, then ``seq_len - 1`` categorical steps from
    the rows ``rows_of(tok)`` of the transition logits."""
    tok = torch.randint(0, vocab, lead, generator=gen, device=device)
    out = torch.empty(lead + (seq_len,), dtype=torch.int64, device=device)
    out[..., 0] = tok
    for t in range(1, seq_len):
        probs = torch.softmax(rows_of(tok), dim=-1).reshape(-1, vocab)
        tok = torch.multinomial(probs, 1, generator=gen).reshape(lead)
        out[..., t] = tok
    return out


def batch_iterator(sampler: MarkovMixture, batch: int, seq_len: int,
                   seed: int = 0, mode: str = "shards"):
    """Infinite deterministic iterator; mode: shards|validation. Step n's
    draw comes from a ``torch.Generator`` on the sampler's device seeded
    from (seed, n) through ``numpy.random.SeedSequence``: the JAX
    iterator's ``jax.random.fold_in(key, n)`` streams cannot be
    reproduced, so the two packages yield different tokens of the same
    shapes and distributions."""
    if mode not in ("shards", "validation"):
        raise ValueError(f"mode must be 'shards' or 'validation', got "
                         f"{mode!r}")
    step = 0
    while True:
        gen = torch.Generator(device=sampler.device)
        gen.manual_seed(int(np.random.SeedSequence(
            [int(seed) % 2 ** 63, step]).generate_state(1, np.uint64)[0]))
        if mode == "shards":
            yield sampler.sample_all_shards(gen, batch, seq_len)
        else:
            yield sampler.sample_validation(gen, batch, seq_len)
        step += 1
