"""Pluggable serving policies: admission, preemption and KV eviction
(port of ``repro.serving.policy``, same names and decisions).

``admission``  orders the wait queue (head-of-line per policy);
``preemption`` ranks running requests most-preemptable-first;
``eviction``   picks the cached-free block whose prefix content is dropped.

Resolution: an explicit name or instance, else the innermost
:func:`force_policies` scope's name for the axis (how ``bench.run
--policy`` sweeps triples), else the config hint, else the axis default
(``fcfs`` / ``latest-arrival`` / ``lru``); unknown names raise, and a
scope's names are checked when it is entered.  Every resolution is
appended to each open :func:`record_resolutions` log, so a benchmark row
names the triple that ran.  Scopes and logs are thread-local.

``auto`` and ``predicted-length`` read the replay context of
:mod:`repro_torch.perf.table` when they are built (which is when the engine
resolves its triple): ``auto`` delegates to the scenario's measured winner
in the perf table (counted ``auto_resolved``, else the axis default with
``auto_fallback``), and ``predicted-length`` ranks by the context's
trace-learned decode-length model (else ``max_new_tokens``, counted
``model_absent``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Type, Union)

from repro_torch.core.paged_kv import BlockAllocator, BlockStats
from repro_torch.serving.request import Request, RequestState

ADMISSION = "admission"
PREEMPTION = "preemption"
EVICTION = "eviction"
AXES = (ADMISSION, PREEMPTION, EVICTION)
DEFAULTS = {ADMISSION: "fcfs", PREEMPTION: "latest-arrival", EVICTION: "lru"}
_AUTO_NAMES = (None, "", "default")


class UnknownPolicyError(ValueError):
    """A requested policy name is not registered on its axis."""


class Policy:
    """Base for all policies: a registry name + per-run counters."""

    axis: str = ""
    name: str = ""

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n


class AdmissionPolicy(Policy):
    """Lower :meth:`admission_key` = admitted sooner."""

    axis = ADMISSION

    def admission_key(self, req: Request, now: float) -> Tuple:
        raise NotImplementedError

    def select(self, waiting: Sequence[Request], now: float) -> Request:
        return min(waiting, key=lambda r: self.admission_key(r, now))

    def on_admit(self, req: Request, now: float) -> None:
        self.count("admitted")


class PreemptionPolicy(Policy):
    """HIGHER :meth:`victim_key` = more preemptable."""

    axis = PREEMPTION

    def victim_key(self, req: Request, alloc: BlockAllocator,
                   now: float) -> Tuple:
        raise NotImplementedError

    def rank(self, running: Sequence[Request], alloc: BlockAllocator,
             now: float) -> List[Request]:
        return sorted(running,
                      key=lambda r: self.victim_key(r, alloc, now),
                      reverse=True)

    def on_preempt(self, req: Request, alloc: BlockAllocator) -> None:
        self.count("victims")
        self.count("blocks_reclaimed", len(alloc.table(req.req_id)))


class EvictionPolicy(Policy):
    """Scores cached-free blocks (candidates arrive oldest-freed-first)."""

    axis = EVICTION

    def select(self, candidates: Sequence[int],
               stats: Mapping[int, BlockStats]) -> int:
        raise NotImplementedError

    def on_evict(self, block: int, stats: Mapping[int, BlockStats]) -> None:
        self.count("evictions")

    def demote(self, block: int, stats: Mapping[int, BlockStats]) -> bool:
        """Host-tier gate: demote an evicted block's content (True)?"""
        return True


_BASES = {ADMISSION: AdmissionPolicy, PREEMPTION: PreemptionPolicy,
          EVICTION: EvictionPolicy}
_REGISTRY: Dict[str, Dict[str, Type[Policy]]] = {a: {} for a in AXES}

_STATE = threading.local()


def register(axis: str, name: str) -> Callable[[Type[Policy]], Type[Policy]]:
    """Class decorator: register a policy class under ``name`` on ``axis``."""
    if axis not in AXES:
        raise ValueError(f"unknown policy axis {axis!r}; one of {AXES}")

    def deco(cls: Type[Policy]) -> Type[Policy]:
        if not issubclass(cls, _BASES[axis]):
            raise TypeError(f"{cls.__name__} must subclass "
                            f"{_BASES[axis].__name__}")
        if name in _REGISTRY[axis]:
            raise ValueError(f"{axis}: policy {name!r} registered twice")
        cls.axis = axis
        cls.name = name
        _REGISTRY[axis][name] = cls
        return cls

    return deco


def names(axis: str) -> List[str]:
    """Registered policy names on ``axis`` (default first, rest sorted)."""
    default = DEFAULTS[axis]
    rest = sorted(n for n in _REGISTRY[axis] if n != default)
    return [default] + rest


def get(axis: str, name: str) -> Type[Policy]:
    try:
        return _REGISTRY[axis][name]
    except KeyError:
        raise UnknownPolicyError(
            f"{axis}: unknown policy {name!r}; registered: "
            f"{names(axis)}") from None


# -- scoped override + resolution log ---------------------------------------
def _scope_stack() -> List[Dict[str, str]]:
    if not hasattr(_STATE, "forced"):
        _STATE.forced = []
    return _STATE.forced


def _log_stack() -> List[List[Tuple[str, str]]]:
    if not hasattr(_STATE, "logs"):
        _STATE.logs = []
    return _STATE.logs


@contextlib.contextmanager
def force_policies(*, admission: Optional[str] = None,
                   preemption: Optional[str] = None,
                   eviction: Optional[str] = None) -> Iterator[None]:
    """Scoped policy preference per axis (``None`` axes are untouched);
    names are checked on entry, before any engine is built."""
    scope: Dict[str, str] = {}
    for axis, name in ((ADMISSION, admission), (PREEMPTION, preemption),
                       (EVICTION, eviction)):
        if name not in _AUTO_NAMES:
            get(axis, name)
            scope[axis] = name
    stack = _scope_stack()
    stack.append(scope)
    try:
        yield
    finally:
        stack.pop()


def forced_policy(axis: str) -> Optional[str]:
    """The innermost ``force_policies`` preference for ``axis``, if any."""
    for scope in reversed(_scope_stack()):
        if axis in scope:
            return scope[axis]
    return None


@contextlib.contextmanager
def record_resolutions() -> Iterator[List[Tuple[str, str]]]:
    """Collect the ``(axis, name)`` pairs resolved inside the scope."""
    log: List[Tuple[str, str]] = []
    _log_stack().append(log)
    try:
        yield log
    finally:
        stack = _log_stack()
        for i in range(len(stack) - 1, -1, -1):   # remove by identity
            if stack[i] is log:
                del stack[i]
                break


def _note(axis: str, name: str) -> None:
    for log in _log_stack():
        log.append((axis, name))


def resolve(axis: str, explicit: Union[None, str, Policy] = None, *,
            config: Optional[str] = None) -> Policy:
    """A fresh policy for ``axis``: explicit > scope > config > default.
    An instance passes through, logged under its registered name."""
    if axis not in AXES:
        raise ValueError(f"unknown policy axis {axis!r}; one of {AXES}")
    if isinstance(explicit, Policy):
        if explicit.axis != axis:
            raise ValueError(f"policy instance {explicit.name!r} is an "
                             f"{explicit.axis} policy, not {axis}")
        _note(axis, explicit.name)
        return explicit
    for level in (explicit, forced_policy(axis), config, DEFAULTS[axis]):
        if level not in _AUTO_NAMES:
            cls = get(axis, level)
            _note(axis, level)
            return cls()
    raise UnknownPolicyError(f"{axis}: no default policy registered")


def resolve_triple(*, admission=None, preemption=None, eviction=None,
                   config=None) -> Tuple[AdmissionPolicy, PreemptionPolicy,
                                         EvictionPolicy]:
    """Resolve all three axes (``config`` duck-types ServeConfig)."""
    cfg = {a: getattr(config, a, None) for a in AXES}
    return (resolve(ADMISSION, admission, config=cfg[ADMISSION]),
            resolve(PREEMPTION, preemption, config=cfg[PREEMPTION]),
            resolve(EVICTION, eviction, config=cfg[EVICTION]))


# -- admission ----------------------------------------------------------------
@register(ADMISSION, "fcfs")
class FcfsAdmission(AdmissionPolicy):
    """First come, first served; preempted requests resume first."""

    def admission_key(self, req: Request, now: float) -> Tuple:
        resumed = 0 if req.state is RequestState.PREEMPTED else 1
        return (resumed, req.arrival, req.req_id)


@register(ADMISSION, "priority")
class PriorityAdmission(AdmissionPolicy):
    """Highest ``Request.priority`` first; FCFS within a priority class."""

    def admission_key(self, req: Request, now: float) -> Tuple:
        resumed = 0 if req.state is RequestState.PREEMPTED else 1
        return (-req.priority, resumed, req.arrival, req.req_id)


@register(ADMISSION, "deadline-slo")
class DeadlineAdmission(AdmissionPolicy):
    """Earliest deadline first; deadline-free requests last (FCFS)."""

    def admission_key(self, req: Request, now: float) -> Tuple:
        if req.deadline is None:
            return (1, 0.0, req.arrival, req.req_id)
        return (0, req.deadline, req.arrival, req.req_id)

    def on_admit(self, req: Request, now: float) -> None:
        super().on_admit(req, now)
        if req.deadline is not None and now > req.deadline:
            self.count("deadline_missed")


# -- preemption ---------------------------------------------------------------
@register(PREEMPTION, "latest-arrival")
class LatestArrivalPreemption(PreemptionPolicy):
    """Evict the newest request; the oldest is protected."""

    def victim_key(self, req: Request, alloc: BlockAllocator,
                   now: float) -> Tuple:
        return (req.arrival, req.req_id)


@register(PREEMPTION, "fewest-remaining-tokens")
class FewestRemainingPreemption(PreemptionPolicy):
    """Evict the request with the least generation left to do."""

    def victim_key(self, req: Request, alloc: BlockAllocator,
                   now: float) -> Tuple:
        remaining = req.max_new_tokens - len(req.output)
        return (-remaining, req.arrival, req.req_id)


@register(PREEMPTION, "most-blocks")
class MostBlocksPreemption(PreemptionPolicy):
    """Evict the request holding the most KV blocks."""

    def victim_key(self, req: Request, alloc: BlockAllocator,
                   now: float) -> Tuple:
        return (len(alloc.table(req.req_id)), req.arrival, req.req_id)


# -- eviction -----------------------------------------------------------------
@register(EVICTION, "lru")
class LruEviction(EvictionPolicy):
    """Drop the oldest-freed block."""

    def select(self, candidates: Sequence[int],
               stats: Mapping[int, BlockStats]) -> int:
        return next(iter(candidates))


@register(EVICTION, "hit-rate")
class HitRateEviction(EvictionPolicy):
    """Drop the block with the fewest lifetime hits (tie: LRU)."""

    def select(self, candidates: Sequence[int],
               stats: Mapping[int, BlockStats]) -> int:
        return min(enumerate(candidates),
                   key=lambda iv: (stats[iv[1]].hits, iv[0]))[1]


@register(EVICTION, "refcount-aware")
class RefcountAwareEviction(EvictionPolicy):
    """Drop never-shared blocks first (peak refcount 1), then fewest hits."""

    def select(self, candidates: Sequence[int],
               stats: Mapping[int, BlockStats]) -> int:
        return min(enumerate(candidates),
                   key=lambda iv: (stats[iv[1]].peak_ref, stats[iv[1]].hits,
                                   iv[0]))[1]


@register(EVICTION, "tiered")
class TieredEviction(EvictionPolicy):
    """Evict the coldest block; demote only blocks with shown reuse."""

    def select(self, candidates: Sequence[int],
               stats: Mapping[int, BlockStats]) -> int:
        return min(enumerate(candidates),
                   key=lambda iv: (stats[iv[1]].hits, stats[iv[1]].peak_ref,
                                   iv[0]))[1]

    def demote(self, block: int, stats: Mapping[int, BlockStats]) -> bool:
        st = stats.get(block, BlockStats())
        keep = st.hits > 0 or st.peak_ref > 1
        self.count("demoted" if keep else "dropped")
        return keep


# -- measured-table consumers: auto and predicted-length -----------------------
class _AutoDelegate:
    """Resolve ``auto`` to the winner of the active (scenario, perf table)
    for this axis, else the axis default; count which and what."""

    def _resolve_delegate(self) -> Policy:
        from repro_torch.perf import table as perf_table  # lazy: no cycle
        name = perf_table.resolve_winner(self.axis)
        if name is None or name == self.name:
            self.count("auto_fallback")
            name = DEFAULTS[self.axis]
        else:
            self.count("auto_resolved")
        self.count(f"resolved_{name.replace('-', '_')}")
        self.resolved = name
        return get(self.axis, name)()


@register(ADMISSION, "auto")
class AutoAdmission(AdmissionPolicy, _AutoDelegate):
    def __init__(self) -> None:
        super().__init__()
        self._impl = self._resolve_delegate()

    def admission_key(self, req: Request, now: float) -> Tuple:
        return self._impl.admission_key(req, now)


@register(PREEMPTION, "auto")
class AutoPreemption(PreemptionPolicy, _AutoDelegate):
    def __init__(self) -> None:
        super().__init__()
        self._impl = self._resolve_delegate()

    def victim_key(self, req: Request, alloc: BlockAllocator,
                   now: float) -> Tuple:
        return self._impl.victim_key(req, alloc, now)


@register(EVICTION, "auto")
class AutoEviction(EvictionPolicy, _AutoDelegate):
    def __init__(self) -> None:
        super().__init__()
        self._impl = self._resolve_delegate()

    def select(self, candidates: Sequence[int],
               stats: Mapping[int, BlockStats]) -> int:
        return self._impl.select(candidates, stats)

    def demote(self, block: int, stats: Mapping[int, BlockStats]) -> bool:
        return self._impl.demote(block, stats)


@register(ADMISSION, "predicted-length")
class PredictedLengthAdmission(AdmissionPolicy):
    """Shortest predicted remaining work first: (re)prefill of prompt +
    output plus the predicted remaining decode, from the replay context's
    :class:`~repro_torch.perf.trace.LengthModel` (else ``max_new_tokens``,
    counted ``model_absent``); preempted requests resume first."""

    def __init__(self) -> None:
        super().__init__()
        from repro_torch.perf import table as perf_table  # lazy: no cycle
        self.model = perf_table.active_length_model()
        if self.model is None:
            self.count("model_absent")

    def admission_key(self, req: Request, now: float) -> Tuple:
        resumed = 0 if req.state is RequestState.PREEMPTED else 1
        done = len(req.output)
        if self.model is not None:
            predicted = max(self.model.predict(len(req.prompt)) - done, 0.0)
        else:
            predicted = float(req.max_new_tokens - done)
        remaining = len(req.prompt) + done + predicted
        return (resumed, remaining, req.arrival, req.req_id)
