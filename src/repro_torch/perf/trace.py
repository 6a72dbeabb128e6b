"""Request traces: seeded synthetic workload mixtures with JSON load/save
(port of ``repro.perf.trace``; the same numpy ``default_rng`` draws, so the
same (seed, parameters) give the reference's trace bit for bit).

A :class:`Trace` holds per-request virtual arrival times, prompt token ids,
generation budgets and the priority/deadline fields admission policies
read.  Scenarios: ``bursty`` (arrival waves), ``shared-prefix``
(prefix-cache pressure), ``long-tail`` (a few long generations among short
ones) and ``mixed`` (all three interleaved).

:class:`LengthModel` is the cost model behind ``predicted-length``
admission: a prompt-length-bucketed decode-length estimate fit from a
trace.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request, SamplingParams, bucket_pow2

TRACE_SCHEMA_VERSION = 1

SCENARIOS = ("bursty", "shared-prefix", "long-tail", "mixed")


@dataclass
class TraceRequest:
    """One request in a trace; times are virtual seconds from trace start."""

    req_id: int
    arrival: float
    prompt: List[int]
    max_new_tokens: int
    priority: int = 0
    deadline: Optional[float] = None

    def as_dict(self) -> Dict:
        return {
            "req_id": self.req_id,
            "arrival": self.arrival,
            "prompt": list(int(t) for t in self.prompt),
            "max_new_tokens": int(self.max_new_tokens),
            "priority": int(self.priority),
            "deadline": self.deadline,
        }


@dataclass
class Trace:
    """A pinned workload: requests sorted by (arrival, req_id)."""

    name: str
    scenario: str
    seed: int
    vocab_size: int
    step_period: float = 0.05  # virtual seconds per engine step
    requests: List[TraceRequest] = field(default_factory=list)

    def as_dict(self) -> Dict:
        return {
            "trace_schema_version": TRACE_SCHEMA_VERSION,
            "name": self.name,
            "scenario": self.scenario,
            "seed": self.seed,
            "vocab_size": self.vocab_size,
            "step_period": self.step_period,
            "requests": [r.as_dict() for r in self.requests],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Trace":
        version = d.get("trace_schema_version")
        if version != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace schema {version!r} != supported {TRACE_SCHEMA_VERSION}")
        reqs = [TraceRequest(req_id=r["req_id"], arrival=r["arrival"],
                             prompt=list(r["prompt"]),
                             max_new_tokens=r["max_new_tokens"],
                             priority=r.get("priority", 0),
                             deadline=r.get("deadline"))
                for r in d["requests"]]
        return cls(name=d["name"], scenario=d["scenario"], seed=d["seed"],
                   vocab_size=d["vocab_size"], step_period=d["step_period"],
                   requests=reqs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_requests(self, base: float = 0.0) -> List[Request]:
        """Materialize serving Requests with arrivals offset by ``base``.

        ``base`` is normally the wall-clock instant replay starts, so arrival
        *comparisons* (all any policy does with arrivals) match the virtual
        order exactly while engine-side wall timestamps stay sane.
        """
        out = []
        for tr in self.requests:
            out.append(Request(
                req_id=tr.req_id,
                prompt=np.asarray(tr.prompt, dtype=np.int32),
                max_new_tokens=tr.max_new_tokens,
                sampling=SamplingParams(temperature=0.0),
                arrival=base + tr.arrival,
                priority=tr.priority,
                deadline=None if tr.deadline is None else base + tr.deadline,
            ))
        return out

    def max_positions(self) -> int:
        return max((len(r.prompt) + r.max_new_tokens for r in self.requests),
                   default=0)


def _finish(requests: List[TraceRequest]) -> List[TraceRequest]:
    requests.sort(key=lambda r: (r.arrival, r.req_id))
    for i, r in enumerate(requests):
        r.req_id = i
    return requests


def _prompt(rng: np.random.Generator, lo: int, hi: int, vocab: int,
            prefix: Optional[List[int]] = None) -> List[int]:
    n = int(rng.integers(lo, hi + 1))
    body = rng.integers(0, vocab, size=n).tolist()
    return (list(prefix) + body) if prefix else body


def _gen_len(rng: np.random.Generator, prompt_len: int, cap: int) -> int:
    # Correlate decode length with the prompt-length bucket so the
    # predicted-length cost model has signal to learn.
    return int(min(cap, 2 + prompt_len // 3 + int(rng.integers(0, 3))))


def generate(scenario: str, *, seed: int = 0, n_requests: int = 8,
             vocab_size: int = 256, step_period: float = 0.05,
             prompt_lo: int = 4, prompt_hi: int = 14, gen_cap: int = 12,
             shared_prefix_len: int = 8, name: Optional[str] = None) -> Trace:
    """Deterministically generate a synthetic trace for ``scenario``."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}; one of {SCENARIOS}")
    rng = np.random.default_rng(seed)
    reqs: List[TraceRequest]
    if scenario == "bursty":
        reqs = _bursty(rng, n_requests, vocab_size, prompt_lo, prompt_hi,
                       gen_cap)
    elif scenario == "shared-prefix":
        reqs = _shared_prefix(rng, n_requests, vocab_size, prompt_lo,
                              prompt_hi, gen_cap, shared_prefix_len)
    elif scenario == "long-tail":
        reqs = _long_tail(rng, n_requests, vocab_size, prompt_lo, prompt_hi,
                          gen_cap)
    else:  # mixed: one slice of each shape, interleaved on the same clock.
        per = max(2, n_requests // 3)
        reqs = (_bursty(rng, per, vocab_size, prompt_lo, prompt_hi, gen_cap)
                + _shared_prefix(rng, per, vocab_size, prompt_lo, prompt_hi,
                                 gen_cap, shared_prefix_len)
                + _long_tail(rng, n_requests - 2 * per, vocab_size, prompt_lo,
                             prompt_hi, gen_cap))
    return Trace(name=name or f"{scenario}-s{seed}-n{n_requests}",
                 scenario=scenario, seed=seed, vocab_size=vocab_size,
                 step_period=step_period, requests=_finish(reqs))


def _bursty(rng, n, vocab, lo, hi, cap) -> List[TraceRequest]:
    """Arrival waves: clustered bursts every ~0.8 virtual seconds."""
    wave = max(2, n // 3)
    reqs = []
    for i in range(n):
        t = 0.8 * (i // wave) + float(rng.uniform(0.0, 0.1))
        prompt = _prompt(rng, lo, hi, vocab)
        gen = _gen_len(rng, len(prompt), cap)
        deadline = t + 1.0 + float(rng.uniform(0.0, 1.0)) if i % 2 else None
        reqs.append(TraceRequest(req_id=i, arrival=t, prompt=prompt,
                                 max_new_tokens=gen,
                                 priority=int(rng.integers(0, 3)),
                                 deadline=deadline))
    return reqs


def _shared_prefix(rng, n, vocab, lo, hi, cap, prefix_len) -> List[TraceRequest]:
    """Groups of ~3 requests sharing a prompt prefix (prefix-cache pressure)."""
    reqs = []
    prefix: List[int] = []
    for i in range(n):
        if i % 3 == 0:
            prefix = rng.integers(0, vocab, size=prefix_len).tolist()
        t = float(rng.uniform(0.0, 1.2))
        prompt = _prompt(rng, lo, hi, vocab, prefix=prefix)
        gen = _gen_len(rng, len(prompt), cap)
        reqs.append(TraceRequest(req_id=i, arrival=t, prompt=prompt,
                                 max_new_tokens=gen))
    return reqs


def _long_tail(rng, n, vocab, lo, hi, cap) -> List[TraceRequest]:
    """Poisson-ish arrivals; every 4th request is a long-generation outlier."""
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.15))
        long = (i % 4 == 3)
        prompt = _prompt(rng, lo, hi * 2 if long else hi, vocab)
        gen = _gen_len(rng, len(prompt), cap)
        if long:
            gen = min(cap + cap // 2, gen * 3)
        reqs.append(TraceRequest(req_id=i, arrival=t, prompt=prompt,
                                 max_new_tokens=gen,
                                 priority=int(rng.integers(0, 2))))
    return reqs


@dataclass
class LengthModel:
    """Prompt-length-bucketed decode-length estimate learned from a trace.

    Buckets are the pow2 buckets the engine already uses for lane shapes
    (``bucket_pow2``), so the model's granularity matches the scheduler's.
    """

    buckets: Dict[int, float]
    default: float

    @classmethod
    def fit(cls, trace: Trace) -> "LengthModel":
        sums: Dict[int, List[float]] = {}
        for r in trace.requests:
            sums.setdefault(bucket_pow2(len(r.prompt)), []).append(
                float(r.max_new_tokens))
        if not sums:
            return cls(buckets={}, default=1.0)
        buckets = {b: sum(v) / len(v) for b, v in sorted(sums.items())}
        default = sum(float(r.max_new_tokens) for r in trace.requests) / len(
            trace.requests)
        return cls(buckets=buckets, default=default)

    def predict(self, prompt_len: int) -> float:
        """Estimated decode length for a prompt of ``prompt_len`` tokens."""
        b = bucket_pow2(max(1, prompt_len))
        if b in self.buckets:
            return self.buckets[b]
        if self.buckets:  # nearest bucket by log-distance, lower on ties
            best = min(self.buckets,
                       key=lambda k: (abs(math.log2(k) - math.log2(b)), k))
            return self.buckets[best]
        return self.default
