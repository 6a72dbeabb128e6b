"""Elastic scaling + fault tolerance + straggler mitigation (a copy of
``repro.distributed.elastic``: pure Python, no device code).

On a real multi-node deployment the coordinator detects failed hosts;
this module implements the *decision layer* that a 1000+ node
run needs, in a backend-independent way so it is fully testable on CPU:

* :class:`HeartbeatMonitor` — per-host heartbeats with timeout → dead set.
* :func:`plan_remesh` — given surviving chips and the parallelism minima,
  choose the largest valid (pod, data, model) mesh ≤ survivors (whole-pod
  granularity for the pod axis, power-of-two shrink for data).
* the trainer (``repro_torch.training.trainer``) restores from the last
  checkpoint via ``CheckpointManager.restore`` with a placer that puts
  each leaf on its device, and continues: the checkpoint layout is
  topology-free.
* :class:`StragglerWatchdog` — EWMA step-time tracker; flags steps slower
  than ``threshold×`` the moving median. The mitigation is
  re-sharding around the slow host (swap with a hot spare) — the watchdog
  emits the decision; the swap is a remesh with the spare included.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[int], timeout_s: float = 60.0):
        self.timeout = timeout_s
        self._last: Dict[int, float] = {h: time.time() for h in hosts}

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self._last[host] = time.time() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout)

    def alive(self, now: Optional[float] = None) -> List[int]:
        d = set(self.dead(now))
        return sorted(h for h in self._last if h not in d)


def plan_remesh(total_chips: int, chips_per_pod: int, *,
                model_parallel: int, min_data: int = 1
                ) -> Optional[Tuple[int, int, int]]:
    """Largest valid (pods, data, model) mesh from surviving chips.

    Pod axis shrinks in whole pods; within a pod, data shrinks by powers of
    two (keeping global batch divisible). Returns None if nothing fits.
    """
    pods = total_chips // chips_per_pod
    if pods >= 1:
        data = chips_per_pod // model_parallel
        if data >= min_data:
            return (pods, data, model_parallel)
    # sub-pod survivor set: shrink data by powers of two
    data = chips_per_pod // model_parallel
    while data >= max(min_data, 1):
        if data * model_parallel <= total_chips:
            return (1, data, model_parallel)
        data //= 2
    return None


@dataclass
class StragglerWatchdog:
    """EWMA step-time tracker; flags slow steps / slow hosts."""

    threshold: float = 2.0
    alpha: float = 0.1
    _ewma: Optional[float] = None
    slow_steps: List[int] = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        if self._ewma is None:
            self._ewma = dt
            return False
        is_slow = dt > self.threshold * self._ewma
        # slow steps don't poison the baseline
        if not is_slow:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        else:
            self.slow_steps.append(step)
        return is_slow

    @property
    def baseline(self) -> Optional[float]:
        return self._ewma
