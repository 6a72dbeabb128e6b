"""The program's own spans and counters (``repro_torch.perf.spans``) in a
traced window.

The port opens a span recording by itself while a ``torch.profiler`` runs
over its engine steps, which the traced window does, and keeps it in
memory.  :func:`log_of` finds that recording for a window (None where the
program has none, as a program without spans has not); :func:`note`
writes what it holds to the window's notes once: spans and counters a
step, each span's time in each step (:func:`per_step_ms`), the queue,
the check against the engine's ``phase_s``, and any program range the
trace holds as a device kernel (:func:`device_ranges`).

:func:`on_device_trace` reduces the profiler's events against the same
spans, which the profiler stamps on its own timeline as
``repro_torch.<name>`` ranges on the host:

* ``idle_by_span``: device idle seconds by the innermost program span open
  at each gap's middle (``none`` where no span was);
* ``device_s_by_span`` / ``launches_by_span``: device seconds of the
  kernels launched inside each span (a kernel is its launch's by
  correlation id), and the launches, counted for the span and every span
  round it; ``device_s_by_span_either_id`` also takes a kernel whose
  linked id is a launch's, as ``harness/trace.py`` does for its spans;
* ``device_annotations``: ``repro_torch.*`` events on the device timeline
  (the program's ranges are function-scope, so none is expected).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.harness import trace as trace_lib
from perfbench.harness.stats import nearest_rank

PREFIX = "repro_torch."
HOST_PHASES = ("engine.propose", "engine.schedule", "engine.render",
               "engine.pool_sync", "engine.commit")
ENGINE_PHASES = ("propose", "schedule_render", "commit")


def log_of(w):
    """The program's span log of the traced window ``w``, or None."""
    if w.trace is None or not w.steps:
        return None
    try:
        from repro_torch.perf import spans
    except ImportError:
        return None
    log = spans.profiled_log()
    if log is None or not w.t0 <= log.t_start * 1e-9 <= w.t1:
        return None
    return log


def queue_ms(w, log) -> List[Tuple[float, float]]:
    """``(submit -> first lanes, admit -> first lanes)`` in ms for every
    request submitted while the program recorded whose first prefill lanes
    were placed in the window.  (A request sent before the recording
    opened is left out: its wait holds the profiler's start.)"""
    out = []
    for ev in log.marks.values():
        first = ev.get("first_lanes")
        if "submit" in ev and first is not None and w.inside(first * 1e-9):
            out.append((1e-6 * (first - ev["submit"]),
                        1e-6 * (first - ev["admit"])))
    return out


def per_step_ms(w, log) -> Dict[str, Dict[str, float]]:
    """Each span's ms in each step that ended in the window, by the step
    id the span carries (an overlapped step's wait and commit count for
    the step they resolve), as p50 / p95 / max over those steps."""
    steps = {r.step for r in log.records
             if r.name == "engine.step" and r.end and w.inside(r.end * 1e-9)}
    by: Dict[str, Dict[int, int]] = defaultdict(lambda: defaultdict(int))
    for r in log.records:
        if r.end and r.step in steps:
            by[r.name][r.step] += r.end - r.start
    out = {}
    for name, ns in sorted(by.items()):
        ms = [1e-6 * ns.get(s, 0) for s in steps]
        out[name] = {"p50": nearest_rank(ms, 0.5),
                     "p95": nearest_rank(ms, 0.95), "max": max(ms)}
    return out


def device_ranges(w) -> Dict[str, float]:
    """Device seconds the trace holds under ``repro_torch.*`` names as
    kernels: program ranges mirrored onto the device timeline, which
    ``harness/trace.py`` would count as busy time.  None is expected (the
    ranges are function-scope); :func:`note` flags any."""
    if w.trace is None:
        return {}
    return {k: v for k, v in w.trace.device_s_by_kernel.items()
            if k.startswith(PREFIX)}


def note(w, log) -> None:
    """The log's spans, counters and queue in ``w.notes`` (once)."""
    if "program spans" in w.notes:
        return
    n = len(w.steps)
    w.notes["program spans"] = {
        name: {"per_step": c / n, "ms_per_step": 1e-6 * t / n,
               "self_ms_per_step": 1e-6 * s / n}
        for name, (c, t, s) in sorted(log.stats.items())}
    deltas = log.deltas()
    evictions = deltas.get("alloc.cache_evictions", 0)
    counters = {"steps_recorded": log.steps, "steps_in_window": n,
                **deltas}
    counters.update({f"{k}_ms": 1e-6 * v for k, v in log.ns.items()})
    counters.update(log.counts)
    if evictions:
        counters["cached_free_per_eviction"] = (
            log.counts.get("kv.cached_free_at_evict", 0) / evictions)
    w.notes["program counters"] = counters
    spans_ms = sum(1e-6 * log.stats.get(k, (0, 0, 0))[1] for k in HOST_PHASES)
    phase_ms = sum(1e3 * w.phase_s.get(k, 0.0) for k in ENGINE_PHASES)
    w.notes["program host phases vs phase_s ms"] = {
        "spans": spans_ms, "phase_s": phase_ms,
        "ratio": spans_ms / phase_ms if phase_ms else None}
    w.notes["program ms a step, over steps"] = per_step_ms(w, log)
    mirrored = device_ranges(w)
    if mirrored:
        w.notes["program ranges on the device, counted as kernels"] = mirrored
    q = queue_ms(w, log)
    if q:
        waits = [a for a, _ in q]
        lanes = [b for _, b in q]
        w.notes["program queue ms"] = {
            "requests": len(q), "max": max(waits),
            "submit_to_first_lanes_p50": nearest_rank(waits, 0.5),
            "submit_to_first_lanes_p95": nearest_rank(waits, 0.95),
            "admit_to_first_lanes_p50": nearest_rank(lanes, 0.5),
            "admit_to_first_lanes_p95": nearest_rank(lanes, 0.95)}


def _innermost(starts, ends, parent, t) -> int:
    """Index of the innermost span open at ``t`` (spans sorted by start,
    properly nested), or -1."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0 and ends[j] <= t:
        j = parent[j]
    return j


def _nest(intervals):
    """Each span's enclosing span, for spans sorted by (start, -end)."""
    parent, stack = [], []
    for s, e, _ in intervals:
        while stack and intervals[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def on_device_trace(events) -> Dict[str, object]:
    """The reduction of the module docstring, over kineto events."""
    device: List[Tuple[int, int]] = []
    kernels: List[Tuple[int, int, int]] = []        # (id, linked id, ns)
    launches: List[Tuple[int, int]] = []            # (start, id)
    intervals: List[Tuple[int, int, str]] = []
    device_annotations = 0
    for e in events:
        name = e.name()
        on_device = e.device_type().name != "CPU"
        if name.startswith(PREFIX):
            if on_device:
                device_annotations += 1
            else:
                s = e.start_ns()
                intervals.append((s, s + e.duration_ns(), name[len(PREFIX):]))
            continue
        kind = trace_lib._kind(e)
        if kind in trace_lib.DEVICE_KINDS:
            s = e.start_ns()
            device.append((s, s + e.duration_ns()))
            if kind == "kernel":
                kernels.append((e.correlation_id(), e.linked_correlation_id(),
                                e.duration_ns()))
        elif name in trace_lib.LAUNCH_NAMES:
            launches.append((e.start_ns(), e.correlation_id()))
    intervals.sort(key=lambda iv: (iv[0], -iv[1]))
    starts = [s for s, _, _ in intervals]
    ends = [e for _, e, _ in intervals]
    parent = _nest(intervals)

    def chain(j):
        names = set()
        while j >= 0:
            names.add(intervals[j][2])
            j = parent[j]
        return names

    merged = trace_lib._merge(device)
    idle: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        j = _innermost(starts, ends, parent, (end + nxt) // 2)
        idle[intervals[j][2] if j >= 0 else "none"] += (nxt - end) * 1e-9
    span_of: Dict[int, set] = {}
    n_launch: Dict[str, int] = defaultdict(int)
    for t, cid in launches:
        names = chain(_innermost(starts, ends, parent, t))
        span_of[cid] = names
        for name in names:
            n_launch[name] += 1
    device_s: Dict[str, float] = defaultdict(float)
    either: Dict[str, float] = defaultdict(float)
    for cid, lcid, ns in kernels:
        for name in span_of.get(cid, ()):
            device_s[name] += ns * 1e-9
        for name in span_of.get(cid, set()) | span_of.get(lcid, set()):
            either[name] += ns * 1e-9
    total_idle = sum(idle.values())
    return {"idle_by_span": dict(idle),
            "idle_outside_share": (idle.get("none", 0.0) / total_idle
                                   if total_idle else None),
            "device_s_by_span": dict(device_s),
            "device_s_by_span_either_id": dict(either),
            "launches_by_span": dict(n_launch),
            "spans": len(intervals),
            "device_annotations": device_annotations}
