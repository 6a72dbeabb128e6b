"""Deterministic virtual-time trace replay + SLO scoring (port of
``repro.perf.replay``).

The replay clock is the engine step counter: one ``step()`` = one tick of
``trace.step_period`` virtual seconds.  Before each step every trace request
whose arrival is due is submitted; when the engine drains while arrivals
remain, the clock fast-forwards to the next arrival (a counted idle skip).
Under greedy sampling every number reported here — per-request TTFT/TPOT in
steps, total steps, tokens per step, preemptions, prefix hits — is
bit-stable across runs and hosts, which is what lets
:mod:`repro_torch.perf.gate` diff replay rows.

SLO scoring converts step-counted latencies to virtual seconds via
``step_period`` and compares nearest-rank percentiles
(:func:`repro_torch.serving.metrics.percentile`) with p99 TTFT/TPOT
targets.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.perf.trace import Trace
from repro_torch.serving.metrics import percentile
from repro_torch.serving.request import RequestState

__all__ = ["Slo", "RequestTiming", "ReplayResult", "SloReport", "replay",
           "score"]


@dataclass
class Slo:
    """p99 latency targets in virtual seconds."""

    ttft_s: float
    tpot_s: float


@dataclass
class RequestTiming:
    """Step-indexed lifecycle of one replayed request (all deterministic)."""

    req_id: int
    arrival_step: int                      # nominal due step: ceil(arrival/period)
    submit_step: int                       # step index the replayer submitted at
    first_token_step: Optional[int] = None  # steps executed when output[0] seen
    finish_step: Optional[int] = None       # steps executed when FINISHED seen
    output_tokens: int = 0

    @property
    def ttft_steps(self) -> Optional[int]:
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.arrival_step

    @property
    def tpot_steps(self) -> Optional[float]:
        if self.finish_step is None or self.first_token_step is None:
            return None
        return ((self.finish_step - self.first_token_step)
                / max(self.output_tokens - 1, 1))


@dataclass
class ReplayResult:
    trace: Trace
    outputs: Dict[int, List[int]]
    timings: Dict[int, RequestTiming]
    steps: int
    idle_fastforwards: int
    metrics: Dict = field(default_factory=dict)

    def ttft_virtual_s(self) -> List[float]:
        return [t.ttft_steps * self.trace.step_period
                for t in self.timings.values() if t.ttft_steps is not None]

    def tpot_virtual_s(self) -> List[float]:
        return [t.tpot_steps * self.trace.step_period
                for t in self.timings.values() if t.tpot_steps is not None]

    def counters(self) -> Dict[str, float]:
        """The deterministic-counter row the perf table and gate consume."""
        m = self.metrics
        out_tokens = sum(t.output_tokens for t in self.timings.values())
        finished = sum(1 for t in self.timings.values()
                       if t.finish_step is not None)
        ttfts = [t.ttft_steps for t in self.timings.values()
                 if t.ttft_steps is not None]
        tpots = [t.tpot_steps for t in self.timings.values()
                 if t.tpot_steps is not None]
        return {
            "steps": self.steps,
            "idle_ff": self.idle_fastforwards,
            "finished": finished,
            "out_tokens": out_tokens,
            "tok_per_step": round(out_tokens / max(self.steps, 1), 4),
            "prefix_hits": m.get("prefix_hits", 0),
            "preempt": m.get("preemptions", 0),
            "p99_ttft_steps": percentile(ttfts, 99),
            "p99_tpot_steps": round(percentile(tpots, 99), 4),
        }


def replay(engine, trace: Trace, *, max_steps: int = 100_000) -> ReplayResult:
    """Feed ``engine`` from ``trace`` arrivals on the virtual clock.

    ``engine`` is any object with the ServingEngine surface used here
    (``submit`` / ``step`` / ``busy`` / ``metrics``) — DisaggEngine included.
    """
    period = trace.step_period
    base = time.time()  # wall offset: keeps engine-side timestamps monotone
    requests = trace.to_requests(base=base)
    order = sorted(range(len(requests)),
                   key=lambda i: (trace.requests[i].arrival,
                                  trace.requests[i].req_id))
    timings: Dict[int, RequestTiming] = {}
    live = {}  # req_id -> Request, for step-indexed lifecycle tracking
    step = 0
    idle_ff = 0
    i = 0
    while i < len(order) or engine.busy:
        now = step * period
        while i < len(order):
            tr = trace.requests[order[i]]
            if tr.arrival > now + 1e-9:
                break
            req = requests[order[i]]
            engine.submit(req)
            live[tr.req_id] = req
            timings[tr.req_id] = RequestTiming(
                req_id=tr.req_id,
                arrival_step=int(math.ceil(tr.arrival / period)),
                submit_step=step)
            i += 1
        if not engine.busy:
            # Engine drained before the next arrival: fast-forward the clock.
            nxt = trace.requests[order[i]].arrival
            step = max(step + 1, int(math.ceil(nxt / period)))
            idle_ff += 1
            continue
        engine.step()
        step += 1
        if step > max_steps:
            raise RuntimeError(f"replay exceeded max_steps={max_steps}")
        for rid, req in live.items():
            t = timings[rid]
            if t.first_token_step is None and len(req.output) > 0:
                t.first_token_step = step
            if t.finish_step is None and req.state == RequestState.FINISHED:
                t.finish_step = step
                t.output_tokens = len(req.output)
    outputs = {rid: list(req.output) for rid, req in live.items()}
    return ReplayResult(trace=trace, outputs=outputs, timings=timings,
                        steps=step, idle_fastforwards=idle_ff,
                        metrics=engine.metrics())


@dataclass
class SloReport:
    """Percentile summary (virtual seconds) vs the p99 targets."""

    p50_ttft_s: float
    p90_ttft_s: float
    p99_ttft_s: float
    p50_tpot_s: float
    p90_tpot_s: float
    p99_tpot_s: float
    attainment_ttft: float  # fraction of requests with ttft <= slo.ttft_s
    attainment_tpot: float
    ok: bool

    def as_dict(self) -> Dict:
        return dict(self.__dict__)


def score(result: ReplayResult, slo: Slo) -> SloReport:
    ttfts = result.ttft_virtual_s()
    tpots = result.tpot_virtual_s()
    att_ttft = (sum(1 for v in ttfts if v <= slo.ttft_s) / len(ttfts)
                if ttfts else 0.0)
    att_tpot = (sum(1 for v in tpots if v <= slo.tpot_s) / len(tpots)
                if tpots else 0.0)
    p99_ttft = percentile(ttfts, 99)
    p99_tpot = percentile(tpots, 99)
    return SloReport(
        p50_ttft_s=percentile(ttfts, 50), p90_ttft_s=percentile(ttfts, 90),
        p99_ttft_s=p99_ttft,
        p50_tpot_s=percentile(tpots, 50), p90_tpot_s=percentile(tpots, 90),
        p99_tpot_s=p99_tpot,
        attainment_ttft=round(att_ttft, 4), attainment_tpot=round(att_tpot, 4),
        ok=bool(ttfts) and p99_ttft <= slo.ttft_s and p99_tpot <= slo.tpot_s)
