"""The traced window: ``torch.profiler`` over it, reduced in memory to the
numbers the per-layer readers take.  No timeline file is written.

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or fill) ran;
* ``device_s_by_kernel``: device seconds by kernel name;
* ``launches``: kernel launch calls on the host (runtime and driver API);
* ``span_device_s``: device seconds of the kernels launched inside each
  named host span (a launch is inside a span when its host call starts
  within it, on the same thread);
* ``idle_by_host``: device idle seconds, by the host span the harness had
  open in the middle of each gap (``other`` where none was).
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "perfbench."
KERNEL_SPANS = ("moe",)         # spans whose kernels' device time is summed


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    device_s_by_kernel: Dict[str, float] = field(default_factory=dict)
    launches: int = 0
    span_device_s: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    kinds: Dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0            # spent reducing the trace


def span(name: str):
    """A named host span (``perfbench.<name>``) on the profiler's
    timeline."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


class Spans:
    """Functions of the program run inside named spans until
    :meth:`close` puts the originals back."""

    def __init__(self):
        self._undo = []

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def spanned(*args, **kw):
            with span(name):
                return fn(*args, **kw)

        self._undo.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, spanned)

    def close(self) -> None:
        for obj, attr, old in reversed(self._undo):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
        self._undo = []


@contextlib.contextmanager
def profiled(out: TraceSummary):
    """Profile the body (host and device) and fill ``out`` when it ends."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield
    finally:
        prof.stop()
    t = time.perf_counter()
    summarize(prof.profiler.kineto_results.events(), out)
    out.seconds = time.perf_counter() - t


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _kind(e) -> str:
    """What an event is, from its device and its name (the same on every
    PyTorch release: the event's own activity type is not always bound)."""
    name = e.name()
    on_device = e.device_type().name != "CPU"
    if name.startswith(SPAN_PREFIX):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "host"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def summarize(events, out: TraceSummary) -> TraceSummary:
    """Reduce kineto events (``_KinetoEvent``: name, activity type, start
    and end in ns, thread, correlation ids) to ``out``."""
    device: List[Tuple[int, int]] = []
    by_kernel: Dict[str, int] = defaultdict(int)
    kernel_ids: List[Tuple[int, int, int]] = []
    launches: List[Tuple[int, int, int]] = []         # (start, thread, id)
    spans: Dict[str, List[Tuple[int, int, int]]] = defaultdict(list)
    kinds: Dict[str, int] = defaultdict(int)
    for e in events:
        kind = _kind(e)
        kinds[kind] += 1
        name = e.name()
        if kind in DEVICE_KINDS:
            s = e.start_ns()
            d = e.duration_ns()
            device.append((s, s + d))
            if kind == "kernel":
                by_kernel[name] += d
                kernel_ids.append((e.correlation_id(),
                                   e.linked_correlation_id(), d))
        elif name in LAUNCH_NAMES:
            launches.append((e.start_ns(), e.start_thread_id(),
                             e.correlation_id()))
        elif kind == "user_annotation":
            s = e.start_ns()
            spans[name[len(SPAN_PREFIX):]].append(
                (s, s + e.duration_ns(), e.start_thread_id()))
    merged = _merge(device)
    out.busy_s = sum(e - s for s, e in merged) * 1e-9
    out.device_s_by_kernel = {k: v * 1e-9 for k, v in by_kernel.items()}
    out.launches = len(launches)
    out.kinds = dict(kinds)
    for label in KERNEL_SPANS:
        ids = _launches_inside(launches, spans.get(label, []))
        out.span_device_s[label] = 1e-9 * sum(
            d for c, lc, d in kernel_ids if c in ids or lc in ids)
    host = {k: v for k, v in spans.items() if k not in KERNEL_SPANS}
    out.idle_by_host = _idle_by_host(merged, host)
    return out


def _launches_inside(launches, intervals) -> set:
    """Correlation ids of the launches that start inside ``intervals``
    (on the interval's thread)."""
    if not intervals:
        return set()
    intervals = sorted(intervals)
    starts = [s for s, _, _ in intervals]
    ids = set()
    for t, thread, cid in launches:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < intervals[i][1] and thread == intervals[i][2]:
            ids.add(cid)
    return ids


def _idle_by_host(merged, host) -> Dict[str, float]:
    """Idle seconds between the device's busy intervals, by the host span
    open at each gap's middle (the spans are the harness's, one level,
    not nested)."""
    flat = sorted((s, e, name) for name, ivs in host.items()
                  for s, e, _ in ivs)
    starts = [s for s, _, _ in flat]
    idle: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = (end + nxt) // 2
        i = bisect.bisect_right(starts, mid) - 1
        label = flat[i][2] if i >= 0 and mid < flat[i][1] else "other"
        idle[label] += (nxt - end) * 1e-9
    return dict(idle)
