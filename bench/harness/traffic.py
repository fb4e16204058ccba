"""The one traffic generator: every mix under ``bench/traffic/`` is data that
this module reads.

Seeding.  A mix names a ``mix_seed``: it fixes the multiset of request sizes
and inter-arrival gaps, so every run seed does the same work: a window's
ONLINE schedule is the same set of arrivals and sizes on every seed.  The run seed
orders the whole stream (which size lands at which position, which gap
follows which, so where the bursts fall) and draws the token ids.  Seeds may
exceed 32 bits; they go through ``SeedSequence``.

Token ids follow a Zipf unigram law (probability of rank r proportional to
1 / r); training rows add a sticky successor table (a token is followed by a
fixed successor half the time), the law of the port's ``SyntheticDataset``.
"""
from __future__ import annotations

import numpy as np

#: stream ids under one run seed, so streams never share draws
STREAMS = {"train": 1, "offline": 2, "online": 3, "warmup": 4, "sample": 5, "arrivals": 6}


def rng(seed: int, stream: str, *more: int) -> np.random.Generator:
    """A generator for one named stream of one seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), STREAMS[stream], *more]))


def zipf_probs(vocab: int) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    return p / p.sum()


def draw_lengths(spec: dict, n: int, g: np.random.Generator) -> np.ndarray:
    """``n`` lengths by ``spec``: ``{"median", "sigma", "min", "max"}`` is a
    lognormal clipped to ``[min, max]``; ``{"min", "max"}`` alone is uniform
    over the integers of ``[min, max]``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if "median" in spec:
        x = g.lognormal(np.log(float(spec["median"])), float(spec["sigma"]), n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    return g.integers(lo, hi + 1, n).astype(np.int64)


class RequestStream:
    """An endless stream of ``(prompt int32 array, max_new_tokens)`` for one
    request class of a mix (``spec``: ``prompt`` and ``output`` length specs,
    ``mix_seed``).  Sizes repeat in blocks of ``block`` requests: the block's
    sizes are fixed by the mix seed, their order in each block by the run
    seed and the block's index.  A caller that knows how many requests it
    takes passes that many as ``block``."""

    def __init__(self, spec: dict, vocab: int, seed: int, stream: str, block: int = 256):
        base = np.random.default_rng(int(spec.get("mix_seed", 0)))
        self.prompt_lens = draw_lengths(spec["prompt"], block, base)
        self.output_lens = draw_lengths(spec["output"], block, base)
        self.vocab, self.seed, self.stream, self.block = vocab, seed, stream, block
        self.p = zipf_probs(vocab)
        self._i = 0
        self._order = None

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        j, pos = divmod(self._i, self.block)
        if pos == 0:
            self._order = rng(self.seed, self.stream, j).permutation(self.block)
        k = self._order[pos]
        g = rng(self.seed, self.stream, j, pos + 1)
        prompt = g.choice(self.vocab, size=int(self.prompt_lens[k]), p=self.p).astype(np.int32)
        self._i += 1
        return prompt, int(self.output_lens[k])

    def take(self, n: int) -> list:
        return [next(self) for _ in range(n)]


def arrivals(rate: float, seconds: float, mix_seed: int, seed: int, part: int = 0) -> np.ndarray:
    """The open-loop due times (seconds from 0) of a Poisson process at
    ``rate`` over ``seconds``: as many arrivals as ``rate`` makes due
    before ``seconds``, their gaps drawn once from the mix seed, scaled to
    that rate exactly and put in the run seed's order.  So every seed
    offers the same requests over the window, in bursts of its own;
    ``part`` numbers further schedules of the same kind."""
    n = int(rate * seconds)
    if n and n / rate >= seconds:  # the last one falls inside the window
        n -= 1
    gaps = np.random.default_rng(int(mix_seed) + 1).exponential(1.0 / rate, n)
    if n:
        gaps *= (n / rate) / gaps.sum()
    return np.cumsum(gaps[rng(seed, "arrivals", part).permutation(n)])


def train_batches(vocab: int, batch: int, seq_len: int, count: int, seed: int) -> list:
    """``count`` batches ``{"inputs", "labels"}`` of ``[batch, seq_len]``
    int32 rows, every row distinct: Zipf tokens with the sticky successor
    table, labels the inputs shifted by one."""
    g = rng(seed, "train")
    succ = g.integers(0, vocab, size=vocab, dtype=np.int64)
    rows, s = count * batch, seq_len + 1
    fresh = g.choice(vocab, size=(rows, s), p=zipf_probs(vocab))
    sticky = g.random((rows, s)) < 0.5
    toks = fresh.copy()
    for t in range(1, s):
        toks[:, t] = np.where(sticky[:, t], succ[toks[:, t - 1]], fresh[:, t])
    toks = toks.reshape(count, batch, s).astype(np.int32)
    return [{"inputs": np.ascontiguousarray(b[:, :-1]), "labels": np.ascontiguousarray(b[:, 1:])}
            for b in toks]
