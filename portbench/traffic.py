"""The one traffic generator: a mix file's parameters and a seed -> requests.

A mix (``portbench/traffic/<name>.json``) gives:

- ``batch``: the batcher's slots, and ``clients``: closed-loop clients,
  each of which submits its next request when its last one finishes;
- ``prompt`` and ``output``: ``{"min", "max"}`` token counts, drawn
  log-uniform; with ``prefix`` (a shared system prompt of that many
  tokens, registered at set-up) ``prompt`` is the unique suffix after it;
- ``pool``: the sizes come in blocks of this many requests, each block
  holding the pool's quantiles of the log-uniform law in an order drawn
  from the seed. Every block serves the same multiset of prompt and output
  lengths, so a window of many blocks does the same work for every seed
  (a seed changes the order and the token ids, not the amount of work);
- ``temperature``, ``warm_steps`` (closed-loop steps before the window
  opens) and ``check`` (how many served tokens and requests the
  correctness check compares).

The first ``clients`` requests stand for a batch already in flight: their
output budgets are cut to a stratified share of the drawn budget, so that
completions are spread from the first step on rather than all due at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

_SEED_MASK = 2 ** 63 - 1


def seed_words(seed: int, *salt: int) -> list:
    """A numpy seed sequence entropy for ``seed`` (any int) and a salt."""
    return [int(seed) & _SEED_MASK, *salt]


def log_uniform_quantiles(n: int, lo: int, hi: int) -> np.ndarray:
    """The n mid-quantiles of a log-uniform law on [lo, hi], as ints."""
    q = (np.arange(n) + 0.5) / n
    vals = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


@dataclass
class Request:
    index: int
    prompt: List[int]
    budget: int
    shared: int  # leading tokens that are the registered prefix (0: none)


class Traffic:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.batch = int(mix["batch"])
        self.clients = int(mix["clients"])
        self.pool = int(mix["pool"])
        self.temperature = float(mix["temperature"])
        self.warm_steps = int(mix["warm_steps"])
        self.check = dict(mix["check"])
        p, o = mix["prompt"], mix["output"]
        self._prompt_sizes = log_uniform_quantiles(self.pool, int(p["min"]), int(p["max"]))
        self._output_sizes = log_uniform_quantiles(self.pool, int(o["min"]), int(o["max"]))
        n_prefix = int(mix.get("prefix", 0))
        rng = np.random.default_rng(seed_words(seed, 1))
        self.prefix: List[int] = rng.integers(0, self.vocab, n_prefix).tolist()
        u = (np.arange(self.clients) + 0.5) / self.clients
        self._first_share = np.random.default_rng(seed_words(seed, 2)).permutation(u)
        self._orders: dict = {}

    def _order(self, cycle: int):
        if cycle not in self._orders:
            rng = np.random.default_rng(seed_words(self.seed, 3, cycle))
            self._orders[cycle] = (rng.permutation(self.pool), rng.permutation(self.pool))
        return self._orders[cycle]

    def request(self, i: int) -> Request:
        """Request ``i`` of this seed's stream (the same for any call order)."""
        cycle, j = divmod(i, self.pool)
        po, oo = self._order(cycle)
        n = int(self._prompt_sizes[po[j]])
        budget = int(self._output_sizes[oo[j]])
        if i < self.clients:
            budget = max(1, math.ceil(self._first_share[i] * budget))
        ids = np.random.default_rng(seed_words(self.seed, 4, i)).integers(0, self.vocab, n)
        return Request(i, self.prefix + ids.tolist(), budget, len(self.prefix))

    def longest(self) -> int:
        """Rows a request can need: prefix, prompt and output at their most."""
        return len(self.prefix) + int(self._prompt_sizes.max()) + int(self._output_sizes.max())

    def prompt_lengths(self) -> np.ndarray:
        """Every prompt length (after any prefix) the pool holds."""
        return self._prompt_sizes
