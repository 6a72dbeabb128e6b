"""Serving metrics (port of ``repro.serving.metrics``): nearest-rank
TTFT/TPOT percentiles, throughput, tokens per step and per-phase wall time."""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence


def percentile(samples: Sequence[float], p: float) -> float:
    """Nearest-rank percentile: smallest sample with rank >= ceil(pn)."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    n = len(ordered)
    i = max(-(-int(p * n) // 100) - 1, 0)
    return ordered[min(i, n - 1)]


@dataclass
class LatencyTracker:
    samples: List[float] = field(default_factory=list)

    def record(self, v: float) -> None:
        bisect.insort(self.samples, v)

    def percentile(self, p: float) -> float:
        return percentile(self.samples, p)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0


@dataclass
class EngineMetrics:
    """Rollup for one serving-engine run (``ServingEngine.metrics``)."""

    ttft: LatencyTracker = field(default_factory=LatencyTracker)
    tpot: LatencyTracker = field(default_factory=LatencyTracker)
    finished: int = 0
    output_tokens: int = 0
    first_arrival: Optional[float] = None
    last_done: Optional[float] = None
    # which attention implementation the run executed ("cuda" or "plain")
    backend: str = ""
    steps: int = 0
    step_tokens: int = 0
    emitted_tokens: int = 0
    num_idle_steps: int = 0
    phase_s: Dict[str, float] = field(default_factory=dict)

    def record_step(self, *, num_tokens: int, emitted_tokens: int,
                    phases: Dict[str, float], idle: bool = False) -> None:
        if idle:
            self.num_idle_steps += 1
        else:
            self.steps += 1
            self.step_tokens += num_tokens
            self.emitted_tokens += emitted_tokens
        for k, v in phases.items():
            self.phase_s[k] = self.phase_s.get(k, 0.0) + v

    def record_finished(self, *, ttft: Optional[float],
                        tpot: Optional[float], num_output_tokens: int,
                        arrival: float, done_at: float) -> None:
        if ttft is not None:
            self.ttft.record(ttft)
        if tpot is not None:
            self.tpot.record(tpot)
        self.finished += 1
        self.output_tokens += num_output_tokens
        self.first_arrival = (arrival if self.first_arrival is None
                              else min(self.first_arrival, arrival))
        self.last_done = (done_at if self.last_done is None
                          else max(self.last_done, done_at))

    @property
    def elapsed_s(self) -> float:
        if self.first_arrival is None or self.last_done is None:
            return 0.0
        return max(self.last_done - self.first_arrival, 0.0)

    def summary(self) -> Dict[str, object]:
        dt = self.elapsed_s
        return {
            "backend": self.backend,
            "finished": self.finished,
            "output_tokens": self.output_tokens,
            "mean_ttft_s": self.ttft.mean,
            "p50_ttft_s": self.ttft.percentile(50),
            "p90_ttft_s": self.ttft.percentile(90),
            "p99_ttft_s": self.ttft.percentile(99),
            "mean_tpot_s": self.tpot.mean,
            "p50_tpot_s": self.tpot.percentile(50),
            "p90_tpot_s": self.tpot.percentile(90),
            "p99_tpot_s": self.tpot.percentile(99),
            "throughput_tok_s": self.output_tokens / dt if dt > 0 else 0.0,
            "steps": self.steps,
            "num_idle_steps": self.num_idle_steps,
            "tokens_per_step": (self.emitted_tokens / self.steps
                                if self.steps else 0.0),
            "lane_tokens_per_step": (self.step_tokens / self.steps
                                     if self.steps else 0.0),
            "phase_s": dict(self.phase_s),
        }
