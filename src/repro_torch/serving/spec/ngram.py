"""Prompt/generated-token lookup proposer (port of
``repro.serving.spec.ngram``).

If the last ``n`` tokens of ``prompt + output`` occurred earlier, the tokens
that followed that occurrence are the guess.  Matching is longest n-gram
first (``max_n`` down to ``min_n``) and prefers the most recent earlier
occurrence; a match flush against the sequence end proposes however many
tokens remain.  Pure host numpy, deterministic.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.serving.spec.proposer import Proposer, register


@register("ngram")
class NgramProposer(Proposer):
    """Suffix n-gram lookup over ``prompt + output``."""

    def __init__(self, max_n: int = 3, min_n: int = 1) -> None:
        super().__init__()
        assert 1 <= min_n <= max_n, (min_n, max_n)
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, req: Request, k: int) -> np.ndarray:
        ctx = req.resume_tokens()               # prompt + generated, int32
        L = len(ctx)
        if k <= 0 or L < self.min_n + 1:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            suffix = ctx[L - n:]
            # candidate start positions of earlier occurrences, newest first
            windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((windows == suffix).all(axis=1))[0]
            for start in hits[::-1]:
                follow = ctx[start + n:start + n + k]
                if len(follow):
                    return np.asarray(follow, np.int32)
        return np.zeros((0,), np.int32)
