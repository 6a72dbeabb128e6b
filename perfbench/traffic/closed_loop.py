"""Closed-loop traffic: ``clients`` callers, each sending its next request
when the previous one completes.

Lengths are stratified so that every seed serves the same work: each block
of ``block`` consecutive requests holds the same prompt lengths (the
log-normal's quantiles at (i + 0.5) / block, clipped to [min, max]) and
the same output lengths (evenly over [min, max]), each list permuted by
the seed on its own.  Prompt tokens are uniform over the vocabulary, drawn
from the seed, so prompts are distinct and the prefix cache finds nothing.
Every request is greedy.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def prompt_lengths(p: dict, n: int) -> List[int]:
    inv = NormalDist().inv_cdf
    mu, sigma = math.log(p["median"]), p["sigma"]
    return [int(min(max(round(math.exp(mu + sigma * inv((i + 0.5) / n))),
                        p["min"]), p["max"])) for i in range(n)]


def output_lengths(p: dict, n: int) -> List[int]:
    span = p["max"] - p["min"] + 1
    return [p["min"] + int((i + 0.5) * span / n) for i in range(n)]


class ClosedLoop:
    def __init__(self, params: dict, seed: int, vocab: int):
        self.params = params
        self.clients = int(params["clients"])
        self.block = int(params["block"])
        self.vocab = vocab
        self.rng = np.random.default_rng(seed % (1 << 64))
        self._prompt = prompt_lengths(params["prompt"], self.block)
        self._output = output_lengths(params["output"], self.block)
        self._queue: List[Tuple[int, int]] = []

    def next(self) -> Tuple[np.ndarray, int]:
        """The next request: (prompt token ids int32, output tokens)."""
        if not self._queue:
            self._queue = list(zip(self.rng.permutation(self._prompt),
                                   self.rng.permutation(self._output)))[::-1]
        n_prompt, n_out = self._queue.pop()
        prompt = self.rng.integers(0, self.vocab, size=int(n_prompt),
                                   dtype=np.int32)
        return prompt, int(n_out)


def make(params: dict, seed: int, vocab: int) -> ClosedLoop:
    return ClosedLoop(params, seed, vocab)
