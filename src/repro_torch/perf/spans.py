"""Spans and counters inside the port: the program's own timeline of a
serving step, kept in memory.

Off by default.  Off, each site costs one check of a module global: no
allocation, no clock read, no torch call.  A recording is on between
:func:`start` and :func:`stop` (or inside :func:`recording`), and, when
none is open, while a ``torch.profiler`` runs over engine steps:
``ServingEngine.step`` calls :func:`follow_profiler` first, which opens a
recording when it finds a profiler running; the first span or step after
the profiler stopped closes it, and :func:`profiled_log` returns it.

At the sites:

* :func:`span` ``(name, step=None)``: a context manager that records one
  span, its parent (the span open on the same thread when it opened) and
  its step: ``step`` if given, else its parent's, else the step
  :func:`next_step` last began;
* :func:`add_ns` / :func:`count`: totals for sites that run too often for
  a span of their own;
* :func:`mark` ``(req_id, event, after=None)``: a request's first stamp
  of ``event`` (with ``after``: once ``after`` is stamped);
* :func:`gauge` ``(name, value)``: a counter the program already keeps,
  read at every step, so the log holds its change over the recording.

Stamps are ``time.perf_counter_ns()``.  While a profiler runs, each span
also opens a function-scope profiler range ``repro_torch.<name>``: the
profiler stamps it on its own host timeline, beside the launches made
inside it, so the device trace and the spans share a clock by
construction.  (A user-scope ``record_function`` range would also be
mirrored onto the device timeline as an annotation; a function-scope one
is not.)
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

import torch.autograd.profiler as _autograd_profiler

PREFIX = "repro_torch."

_active: Optional["Log"] = None        # the open recording; None: off
_followed: Optional["Log"] = None      # the last one follow_profiler opened
_following = False                     # whether the open one is that one


class Record:
    """One span: ``parent`` is the index of the enclosing span in
    :attr:`Log.records` (-1 for none), ``end`` 0 while it is open."""

    __slots__ = ("name", "step", "start", "end", "parent")

    def __init__(self, name: str, step: int, start: int, parent: int):
        self.name, self.step, self.start = name, step, start
        self.end, self.parent = 0, parent


class Log:
    """What one recording holds.

    * ``records``: every span, in the order they opened;
    * ``stats``: by span name ``[count, total ns, self ns]`` (self: the
      span's time less what its child spans cover);
    * ``ns`` / ``counts``: the totals of :func:`add_ns` / :func:`count`;
    * ``marks``: ``req_id -> {event: ns}``, the first stamp of each event;
    * ``gauges``: ``name -> [first, last]`` reading (:meth:`deltas`);
    * ``steps``: steps begun; ``t_start`` / ``t_stop`` the recording's
      bounds (``t_stop`` None while it is open)."""

    def __init__(self, clock: Callable[[], int] = time.perf_counter_ns):
        self.clock = clock
        self.records: List[Record] = []
        self.stats: Dict[str, List[int]] = {}
        self.ns: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.marks: Dict[int, Dict[str, int]] = {}
        self.gauges: Dict[str, List[int]] = {}
        self.steps = 0
        self.step = -1
        self.t_start = clock()
        self.t_stop: Optional[int] = None
        self._local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, ``[record index, child ns]`` each."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def deltas(self) -> Dict[str, int]:
        """Each gauge's change over the recording."""
        return {k: last - first for k, (first, last) in self.gauges.items()}


class _Span:
    __slots__ = ("log", "name", "step", "range")

    def __init__(self, log: Log, name: str, step: Optional[int]):
        self.log, self.name, self.step = log, name, step
        self.range = None

    def __enter__(self):
        log = self.log
        stack = log.stack()
        idx = len(log.records)
        parent = stack[-1][0] if stack else -1
        step = self.step
        if step is None:
            step = log.records[parent].step if parent >= 0 else log.step
        rec = Record(self.name, step, 0, parent)
        log.records.append(rec)
        if _autograd_profiler._is_profiler_enabled:
            from torch._C._profiler import _RecordFunctionFast
            self.range = _RecordFunctionFast(PREFIX + self.name)
            self.range.__enter__()
        stack.append([idx, 0])
        rec.start = log.clock()
        return rec

    def __exit__(self, *exc):
        log = self.log
        t = log.clock()
        stack = log.stack()
        idx, child = stack.pop()
        rec = log.records[idx]
        rec.end = t
        if self.range is not None:
            self.range.__exit__(None, None, None)
        dur = t - rec.start
        st = log.stats.get(self.name)
        if st is None:
            st = log.stats[self.name] = [0, 0, 0]
        st[0] += 1
        st[1] += dur
        st[2] += dur - child
        if stack:
            stack[-1][1] += dur
        return False


_OFF = contextlib.nullcontext()


def active() -> Optional[Log]:
    """The open recording, or None when off."""
    return _active


def span(name: str, step: Optional[int] = None):
    """One span named ``name`` (``repro_torch.<name>`` on a profiler's
    timeline)."""
    log = _active
    if log is None:
        return _OFF
    if _following and not _autograd_profiler._is_profiler_enabled:
        stop()                  # the profiler it followed has stopped
        return _OFF
    return _Span(log, name, step)


def next_step() -> Optional[int]:
    """Begin a step: the id later spans carry (None when off)."""
    log = _active
    if log is None:
        return None
    log.step = log.steps
    log.steps += 1
    return log.step


def current_step() -> Optional[int]:
    """The step :func:`next_step` last began (None when off)."""
    log = _active
    return None if log is None else log.step


def add_ns(name: str, ns: int) -> None:
    log = _active
    if log is not None:
        log.ns[name] = log.ns.get(name, 0) + ns


def count(name: str, n: int = 1) -> None:
    log = _active
    if log is not None:
        log.counts[name] = log.counts.get(name, 0) + n


def mark(req_id: int, event: str, after: Optional[str] = None) -> None:
    """Stamp ``event`` of request ``req_id``, the first time only; with
    ``after``, only once the request's ``after`` is stamped."""
    log = _active
    if log is None:
        return
    events = log.marks.get(req_id)
    if events is None:
        if after is not None:
            return
        events = log.marks[req_id] = {}
    if event not in events and (after is None or after in events):
        events[event] = log.clock()


def gauge(name: str, value: int) -> None:
    log = _active
    if log is not None:
        g = log.gauges.get(name)
        if g is None:
            log.gauges[name] = [value, value]
        else:
            g[1] = value


def start(clock: Callable[[], int] = time.perf_counter_ns) -> Log:
    """Open a recording (one at a time) and return its log.  One opened
    by :func:`follow_profiler` whose profiler has stopped is closed
    first."""
    global _active
    if _active is not None:
        if not _following or _autograd_profiler._is_profiler_enabled:
            raise RuntimeError("a span recording is already open")
        stop()
    _active = Log(clock)
    return _active


def stop() -> Log:
    """Close the open recording and return its log."""
    global _active, _following
    log = _active
    if log is None:
        raise RuntimeError("no span recording is open")
    log.t_stop = log.clock()
    _active, _following = None, False
    return log


@contextlib.contextmanager
def recording(clock: Callable[[], int] = time.perf_counter_ns):
    """A recording over the body; yields its log."""
    log = start(clock)
    try:
        yield log
    finally:
        if _active is log:
            stop()


def follow_profiler() -> None:
    """Open a recording when a ``torch.profiler`` runs and none is open;
    close the one this opened once the profiler has stopped.  Called at
    the top of every engine step."""
    global _followed, _following
    if _autograd_profiler._is_profiler_enabled:
        if _active is None:
            _followed = start()
            _following = True
    elif _following:
        stop()


def profiled_log() -> Optional[Log]:
    """The recording :func:`follow_profiler` opened last (open while its
    profiler runs and until the next span or step), or None."""
    return _followed
