"""Serving request lifecycle (port of ``repro.serving.request``).

    WAITING -> PREFILLING -> DECODING -> FINISHED
       ^           |            |
       '--- PREEMPTED <---------'

Pure host bookkeeping shared by the scheduler and the engine.  A preempted
request releases its KV blocks and re-queues; on re-admission it recomputes
``prompt + output`` (recompute-style preemption), so output tokens survive.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


def bucket_pow2(n: int, lo: int = 8) -> int:
    """Round ``n`` up to a power of two, at least ``lo``."""
    b = lo
    while b < n:
        b *= 2
    return b


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    PREEMPTED = "preempted"
    FINISHED = "finished"


_LEGAL = {
    RequestState.WAITING: {RequestState.PREFILLING},
    RequestState.PREFILLING: {RequestState.DECODING, RequestState.PREEMPTED,
                              RequestState.FINISHED},
    RequestState.DECODING: {RequestState.PREEMPTED, RequestState.FINISHED},
    RequestState.PREEMPTED: {RequestState.PREFILLING, RequestState.FINISHED},
    RequestState.FINISHED: set(),
}


@dataclass(frozen=True)
class SamplingParams:
    """``temperature <= 0`` means greedy; ``top_k <= 0`` / ``top_p >= 1``
    disable the respective filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival: float = field(default_factory=time.time)
    priority: int = 0
    deadline: Optional[float] = None
    state: RequestState = RequestState.WAITING
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    output: List[int] = field(default_factory=list)
    slot: int = -1
    # chunked-prefill cursor into active_prompt (tokens whose KV is cached)
    prefill_pos: int = 0
    num_preemptions: int = 0
    cached_prompt_tokens: int = 0
    # prompt + already-generated tokens; set at admission (recompute resume)
    _active_prompt: Optional[np.ndarray] = None

    def to_state(self, new: RequestState) -> None:
        if new not in _LEGAL[self.state]:
            raise RuntimeError(f"illegal transition {self.state.name} -> "
                               f"{new.name} (req {self.req_id})")
        self.state = new

    def resume_tokens(self) -> np.ndarray:
        """Tokens to (re)prefill: prompt + already-generated output."""
        if not self.output:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.output, np.int32)])

    def begin_prefill(self, slot: int, cached_tokens: int,
                      active_prompt: Optional[np.ndarray] = None) -> None:
        """WAITING/PREEMPTED -> PREFILLING on an engine slot."""
        self._active_prompt = (active_prompt if active_prompt is not None
                               else self.resume_tokens())
        self.to_state(RequestState.PREFILLING)
        self.slot = slot
        self.prefill_pos = cached_tokens
        self.cached_prompt_tokens = cached_tokens

    def preempt(self) -> None:
        self.to_state(RequestState.PREEMPTED)
        self.slot = -1
        self.prefill_pos = 0
        self._active_prompt = None
        self.num_preemptions += 1

    def finish(self, now: Optional[float] = None) -> None:
        self.to_state(RequestState.FINISHED)
        self.done_at = now if now is not None else time.time()
        self.slot = -1

    @property
    def active_prompt(self) -> np.ndarray:
        if self._active_prompt is None:
            raise RuntimeError(f"request {self.req_id} not admitted")
        return self._active_prompt

    @property
    def prefill_remaining(self) -> int:
        return len(self.active_prompt) - self.prefill_pos

    @property
    def ttft(self) -> Optional[float]:
        return (self.first_token_at - self.arrival
                if self.first_token_at else None)

    @property
    def tpot(self) -> Optional[float]:
        if self.done_at is None or self.first_token_at is None:
            return None
        n = max(len(self.output) - 1, 1)
        return (self.done_at - self.first_token_at) / n
