"""Draft-model proposer: a shallow sibling of the target guesses, the target
checks (port of ``repro.serving.spec.draft_model``).

The draft is the target's ``ModelConfig`` with ``depth_frac`` of its layers
(the same vocabulary), rolled out greedily over a clipped context window of
``window`` tokens on the engine's device.  :meth:`propose_batch` runs every
request's rollout together: ``k_max`` forwards of a (Bb, Lb) batch, batch
and length padded right to power-of-two buckets (sound: attention is
causal and rows are independent), proposing exactly what per-request
:meth:`propose` would.  Weights come from the port's seeded generator
unless ``model``/``params`` are injected (a random draft costs acceptance
rate, never correctness).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.serving.request import Request, bucket_pow2
from repro_torch.serving.spec.proposer import Proposer, register


@register("draft-model")
class DraftModelProposer(Proposer):
    """Greedy k-token rollout of a ``max(1, L * depth_frac)``-layer copy of
    the engine's model (or of an injected ``model``/``params``)."""

    def __init__(self, model=None, params=None, *, depth_frac: float = 0.5,
                 window: int = 64, seed: int = 17) -> None:
        super().__init__()
        self.model = model
        self.params = params
        self.depth_frac = depth_frac
        self.window = window
        self.seed = seed
        self._bound = False

    def bind(self, engine) -> None:
        if self.model is None:
            from repro_torch.models.transformer import TransformerLM
            cfg = engine.cfg
            draft_cfg = dataclasses.replace(
                cfg, num_layers=max(1, int(cfg.num_layers * self.depth_frac)))
            self.model = TransformerLM(draft_cfg, device=engine.device)
            self.params = self.model.init(self.seed)
        self._bound = True

    def _greedy_next(self, buf: np.ndarray, idxs: np.ndarray) -> np.ndarray:
        """Each row's argmax token after position ``idxs[row]`` of the
        right-padded ``buf`` (Bb, Lb): one forward of the draft."""
        dev = self.model.device
        toks = torch.from_numpy(buf).to(dev)
        logits, _ = self.model.forward(self.params, toks)
        rows = logits[torch.arange(len(buf), device=dev),
                      torch.from_numpy(idxs).long().to(dev)]
        return torch.argmax(rows, dim=-1).to(torch.int32).cpu().numpy()

    def propose(self, req: Request, k: int) -> np.ndarray:
        if k <= 0 or not self._bound:
            return np.zeros((0,), np.int32)
        ctx = req.resume_tokens()[-self.window:]
        L = len(ctx)
        buf = np.zeros((1, bucket_pow2(L + k, lo=16)), np.int32)
        buf[0, :L] = ctx
        out = np.zeros((k,), np.int32)
        for j in range(k):
            out[j] = self._greedy_next(buf, np.asarray([L - 1 + j]))[0]
            buf[0, L + j] = out[j]
        self.count("draft_forwards", k)
        return out

    def propose_batch(self, reqs: List[Tuple[Request, int]]
                      ) -> Dict[int, np.ndarray]:
        """All requests' rollouts in ``k_max`` batched forwards; a row
        whose ``k`` is spent stops consuming its lane."""
        out = {req.req_id: np.zeros((0,), np.int32) for req, _ in reqs}
        live = [(req, k) for req, k in reqs if k > 0]
        if not live or not self._bound:
            return out
        ctxs = [req.resume_tokens()[-self.window:] for req, _ in live]
        lens = np.asarray([len(c) for c in ctxs], np.int32)
        kmax = max(k for _, k in live)
        Bb = bucket_pow2(len(live), lo=1)
        Lb = bucket_pow2(int(lens.max()) + kmax, lo=16)
        buf = np.zeros((Bb, Lb), np.int32)
        for i, c in enumerate(ctxs):
            buf[i, :len(c)] = c
        idxs = np.zeros((Bb,), np.int32)
        idxs[:len(live)] = lens - 1
        drafts = np.zeros((len(live), kmax), np.int32)
        for j in range(kmax):
            toks = self._greedy_next(buf, idxs + j)
            for i, (_, k) in enumerate(live):
                if j < k:
                    drafts[i, j] = toks[i]
                    buf[i, lens[i] + j] = toks[i]
        self.count("draft_forwards", kmax)
        self.count("batched_rollouts")
        for i, (req, k) in enumerate(live):
            out[req.req_id] = drafts[i, :k]
        return out
