"""The general traffic generator: a traffic file's parameters and a seed
give the requests or batches of one run.

Lengths are fixed, or drawn by quantile: a pool of ``pool`` requests takes the
prompt lengths and the new-token counts at the quantiles
``(i + 0.5) / pool`` of their (truncated) lognormal laws, so every seed
gets the same multiset of lengths; the seed only orders them, pairs them
and draws the token ids.  Requests leave the pool in that order, and a
pool that runs out is drawn again in a new order.
"""
from __future__ import annotations

import statistics

import numpy as np

SEED_MASK = (1 << 63) - 1


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any whole number)."""
    return np.random.default_rng([seed & SEED_MASK, seed >> 63 & 1,
                                  *stream])


def quantile_lengths(law: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of a lognormal law of
    median ``median`` and log-sd ``sigma``, clipped to [min, max]; or, for
    ``{"dist": "fixed", "tokens": k}``, ``n`` times ``k``."""
    dist = law.get("dist", "lognormal")
    if dist == "fixed":
        return np.full(n, law["tokens"], dtype=np.int64)
    if dist != "lognormal":
        raise ValueError(f"length law {law}: 'lognormal' or 'fixed'")
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.rint(law["median"] * np.exp(law["sigma"] * z))
    return np.clip(x, law["min"], law["max"]).astype(np.int64)


class RequestStream:
    """The requests of a closed or open loop: ``next()`` gives (prompt
    int32 array, new tokens), endlessly."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.t = traffic
        self.seed = seed
        self.vocab = vocab
        self.pool = traffic["pool"]
        self.prompts = quantile_lengths(traffic["prompt_tokens"], self.pool)
        self.news = quantile_lengths(traffic["new_tokens"], self.pool)
        self._round = -1
        self._order: list = []
        self._i = 0

    def _refill(self) -> None:
        self._round += 1
        g = rng(self.seed, 1, self._round)
        self._order = list(zip(g.permutation(self.prompts),
                               g.permutation(self.news)))
        self._i = 0

    def next(self) -> tuple[np.ndarray, int]:
        if self._i >= len(self._order):
            self._refill()
        s, n = self._order[self._i]
        self._i += 1
        g = rng(self.seed, 2, self._round, self._i)
        prompt = g.integers(0, self.vocab, size=int(s), dtype=np.int32)
        return prompt, int(n)


def train_batch(traffic: dict, seed: int, vocab: int, step: int) -> dict:
    """Step ``step``'s batch: ``batch`` rows of ``seq_len`` + 1 uniform
    token ids, as tokens and next-token labels (int32)."""
    g = rng(seed, 3, step)
    toks = g.integers(0, vocab, size=(traffic["batch"], traffic["seq_len"] + 1),
                      dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TrainBatches:
    """The port's dataset protocol (``batch_at(step)``) over
    :func:`train_batch`."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.traffic, self.seed, self.vocab = traffic, seed, vocab

    def batch_at(self, step: int) -> dict:
        return train_batch(self.traffic, self.seed, self.vocab, step)
