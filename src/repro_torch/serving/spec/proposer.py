"""Speculative-decoding proposers: the draft side of propose/verify (port of
``repro.serving.spec.proposer``, same registry and counters).

A :class:`Proposer` guesses the next ``k`` tokens of a DECODING request from
host-visible evidence (its own prompt + output, or a small draft model).
The engine scores every guess in ONE fused forward and keeps the longest
accepted prefix (:mod:`repro_torch.serving.spec.verify`): guesses change
speed, never tokens.

Resolution precedence (highest wins): an explicit name or instance (strict),
a ``with force_proposer(name):`` scope, the config hint
(``ServeConfig.spec``), then ``"off"``, which resolves to ``None``.
Resolutions are appended to the active :func:`record_resolutions` scope.
Proposers must be deterministic in the request's state: the delta-q
acceptance rule of ``verify`` assumes a point-mass draft distribution.
"""
from __future__ import annotations

import contextlib
import threading
from typing import (Callable, Dict, Iterator, List, Optional, Tuple, Type,
                    Union)

import numpy as np

from repro_torch.serving.request import Request

__all__ = [
    "OFF", "DEFAULT", "UnknownProposerError", "Proposer", "register",
    "names", "get", "resolve", "force_proposer", "forced_proposer",
    "record_resolutions",
]

OFF = "off"                      # reserved: no speculation (resolves to None)
DEFAULT = OFF

_AUTO_NAMES = (None, "", "default")
# Accepted spellings normalized before lookup ("--spec draft" just works).
ALIASES = {"draft": "draft-model"}


class UnknownProposerError(ValueError):
    """A requested proposer name is not registered (and is not ``"off"``)."""


class Proposer:
    """Base class: a registry name + per-run counters.

    Subclasses implement :meth:`propose` (and optionally the batched
    :meth:`propose_batch`); :meth:`bind` runs once when the engine adopts
    the proposer (build a draft model, size windows, ...).

    ``deterministic`` is a capability declaration, not a hint: the delta-q
    acceptance rule in ``repro.serving.spec.verify`` treats the draft
    distribution as a point mass, which is exact ONLY when ``propose`` is a
    pure function of request state.  A proposer that samples its drafts
    must set ``deterministic = False`` — the engine then refuses to adopt
    it with a clear error instead of silently biasing the emitted
    distribution.
    """

    name: str = ""               # set by @register
    deterministic: bool = True   # propose() is a pure function of req state

    def __init__(self) -> None:
        self.counters: Dict[str, int] = {}

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    # -- engine hooks --------------------------------------------------------
    def bind(self, engine) -> None:
        """Called once by the adopting engine (duck-typed; optional)."""

    def propose(self, req: Request, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``req``'s sequence.

        Must be deterministic in ``req``'s state.  Return shape ``(d,)``
        int32 with ``0 <= d <= k``; an empty array means "no guess" and the
        request decodes normally this step.
        """
        raise NotImplementedError

    def propose_batch(self, reqs: List[Tuple[Request, int]]
                      ) -> Dict[int, np.ndarray]:
        """Drafts for a whole step's DECODING requests in one call.

        ``reqs`` is ``[(request, k), ...]`` (``k <= 0`` ⇒ no budget: return
        empty).  The engine always proposes through this entry point so a
        proposer with device-side work (the draft-model rollout) can batch
        it across requests; the default just loops :meth:`propose`, which
        is exactly right for host-side proposers like ``ngram``.  Must be
        equivalent to the per-request form: ``out[req.req_id] ==
        propose(req, k)`` for every pair.
        """
        return {req.req_id: (self.propose(req, k) if k > 0
                             else np.zeros((0,), np.int32))
                for req, k in reqs}

    # -- bookkeeping the engine drives --------------------------------------
    def on_propose(self, req: Request, drafted: int) -> None:
        self.count("proposals")
        if drafted:
            self.count("proposed_tokens", drafted)
        else:
            self.count("empty")


# ---------------------------------------------------------------------------
# Registry (mirrors repro.serving.policy: register + resolve, scoped
# override, resolution log; thread-local so scopes can't leak across tests).
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Type[Proposer]] = {}
_STATE = threading.local()


def register(name: str) -> Callable[[Type[Proposer]], Type[Proposer]]:
    """Class decorator: register a proposer class under ``name``."""
    if name in (OFF,) + _AUTO_NAMES:
        raise ValueError(f"proposer name {name!r} is reserved")

    def deco(cls: Type[Proposer]) -> Type[Proposer]:
        if not issubclass(cls, Proposer):
            raise TypeError(f"{cls.__name__} must subclass Proposer")
        if name in _REGISTRY:
            raise ValueError(f"proposer {name!r} registered twice")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def names(include_off: bool = True) -> List[str]:
    """Registered proposer names (sorted), with ``"off"`` leading."""
    rest = sorted(_REGISTRY)
    return ([OFF] + rest) if include_off else rest


def get(name: str) -> Type[Proposer]:
    try:
        return _REGISTRY[ALIASES.get(name, name)]
    except KeyError:
        raise UnknownProposerError(
            f"unknown proposer {name!r}; registered: {names()}") from None


def _validate(name: str) -> None:
    if name != OFF:
        get(name)


# -- scoped override + resolution log ---------------------------------------
def _scope_stack() -> List[str]:
    if not hasattr(_STATE, "forced"):
        _STATE.forced = []
    return _STATE.forced


def _log_stack() -> List[List[str]]:
    if not hasattr(_STATE, "logs"):
        _STATE.logs = []
    return _STATE.logs


@contextlib.contextmanager
def force_proposer(name: Optional[str]) -> Iterator[None]:
    """Scoped proposer preference (``None`` leaves resolution untouched).

    Names are validated on entry — a sweep over a typo'd proposer fails
    before any engine is built, not mid-benchmark.  ``"off"`` is a valid
    forced value: it pins speculation OFF even over a config hint.  Aliases
    are normalized here, so :func:`forced_proposer` always reports the
    canonical name.
    """
    if name not in _AUTO_NAMES:
        _validate(name)
        name = ALIASES.get(name, name)
    stack = _scope_stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def forced_proposer() -> Optional[str]:
    """The innermost ``force_proposer`` preference, if any."""
    for name in reversed(_scope_stack()):
        if name not in _AUTO_NAMES:
            return name
    return None


@contextlib.contextmanager
def record_resolutions() -> Iterator[List[str]]:
    """Collect proposer names resolved inside the scope (``"off"`` included)."""
    log: List[str] = []
    _log_stack().append(log)
    try:
        yield log
    finally:
        stack = _log_stack()
        for i in range(len(stack) - 1, -1, -1):   # remove by identity
            if stack[i] is log:
                del stack[i]
                break


def _note(name: str) -> None:
    for log in _log_stack():
        log.append(name)


# -- resolver ----------------------------------------------------------------
def resolve(explicit: Union[None, str, Proposer] = None, *,
            config: Optional[str] = None) -> Optional[Proposer]:
    """Resolve to a fresh :class:`Proposer` instance, or ``None`` for off.

    ``explicit`` may be a registered name, ``"off"``, or an already-built
    proposer instance (injected by tests); instances pass through unchanged
    but are still logged under their registered name.
    """
    if isinstance(explicit, Proposer):
        _note(explicit.name or explicit.__class__.__name__)
        return explicit
    for level in (explicit,                       # 1. explicit — strict
                  forced_proposer(),              # 2. scope
                  config,                         # 3. config hint — strict
                  DEFAULT):                       # 4. default: off
        if level in _AUTO_NAMES:
            continue
        if level == OFF:
            _note(OFF)
            return None
        cls = get(level)
        _note(cls.name)                  # canonical name, aliases normalized
        return cls()
    _note(OFF)
    return None
