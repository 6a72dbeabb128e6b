"""Runtime sanitizers behind the single ``ServeConfig.sanitize`` switch
(port of ``repro.analysis.sanitize``).

Three guards, with the reference's names and counters:

* **Retrace guard.**  ``expect_cached(sig)`` scopes one dispatch of the
  engine's step.  JAX counts its jit compiles there; the port has no jit,
  and what it compiles on the way is a CUDA kernel library that
  ``repro_torch.kernels.build`` builds or loads (``compiles``).  The first
  build for a signature is the warm-up and is free; any later one for a
  signature already seen is a retrace, counted, or raised under
  ``strict``.  On the CPU nothing is built, so ``compiles`` stays 0 where
  the reference counts its compiles.  Today the guard cannot fire: a
  library is built or loaded once per process, so no signature can build
  twice, and ``retraces`` is 0 by construction; it is kept for the
  reference's counters, and it remembers only the signatures whose
  dispatch built something (at most one per library), not every step's.
  It becomes a real check once the step runs as CUDA graphs, captured per
  signature: then it counts their captures.
* **Host-sync guard.**  ``no_host_sync(scope)`` wraps the overlapped
  loop's build half, where a device-to-host read would serialize the
  pipeline.  As in the reference, the guard is engine-cooperative: the
  engine's deliberate round trips go through :func:`host_read`, which
  counts the allowlisted reasons (``disagg-handoff``, ``tier-drain``) and
  trips on any other inside a guarded scope.  On a card the scope also
  runs under ``torch.cuda.set_sync_debug_mode("error")``, so any call
  that waits for the card fails there; an allowlisted :func:`host_read`
  lifts that mode around its own copy.  The mode is process-wide, so it
  is restored on every way out.
* **Allocator invariant checker.**  ``check_allocator`` runs
  ``BlockAllocator.check_invariants``, counting the checks and raising a
  violation as :class:`SanitizeError`.

The counters appear in ``ServingEngine.metrics()["sanitize"]`` and,
flattened, beside ``policy_counters`` (``sanitize.retraces`` and so on).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional, Set, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["SanitizeError", "Sanitizer", "jit_signature", "host_read",
           "DEFAULT_HOST_SYNC_ALLOWLIST"]

# Engine round trips through host memory that are part of the design: the
# disaggregated handoff between pools on different devices, and the host
# tier's demote, which is a device-to-host copy by definition.
DEFAULT_HOST_SYNC_ALLOWLIST = frozenset({"disagg-handoff", "tier-drain"})


class SanitizeError(RuntimeError):
    """A sanitizer invariant was violated (strict mode)."""


def jit_signature(tag: str, *trees: Any) -> Tuple:
    """Hashable signature of one dispatch: the tag, then per tree the
    (shape, dtype) of each tensor or array leaf in order (dict keys
    sorted; a scalar leaf by its type)."""
    sig = [tag]
    for tree in trees:
        leaves = []
        _leaves(tree, leaves)
        sig.append(tuple(leaves))
    return tuple(sig)


def _leaves(node: Any, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            out.append(k)
            _leaves(node[k], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _leaves(v, out)
    else:
        out.append((tuple(getattr(node, "shape", ())),
                    str(getattr(node, "dtype", type(node).__name__))))


# The host-sync guard's scopes, per thread.
_TLS = threading.local()


def _guard_stack():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


@contextlib.contextmanager
def _sync_debug_mode(mode: str) -> Iterator[None]:
    """``torch.cuda.set_sync_debug_mode(mode)`` inside the scope, the mode
    before it restored on every way out."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def host_read(x: torch.Tensor, *, reason: str) -> torch.Tensor:
    """A copy of ``x`` in host memory, declaring why: the engine's single
    doorway for deliberate device-to-host reads.  Outside any guarded
    scope it only copies.  Inside :meth:`Sanitizer.no_host_sync` an
    allowlisted reason is counted (``allowed_host_syncs``) and copies with
    the card's sync guard lifted; any other reason trips the guard
    (raised when strict, counted and lifted otherwise)."""
    stack = _guard_stack()
    if not stack:
        return x.to("cpu", copy=True)
    sanitizer, scope = stack[-1]
    sanitizer._on_host_read(reason, scope)
    lift = (_sync_debug_mode("default") if x.is_cuda
            else contextlib.nullcontext())
    with lift:
        return x.to("cpu", copy=True)


class Sanitizer:
    """One engine's runtime guards (module docstring).  ``strict=True``
    raises :class:`SanitizeError` where a guard trips; ``strict=False``
    only counts."""

    def __init__(self, *, strict: bool = True,
                 host_sync_allowlist: Optional[Set[str]] = None):
        self.strict = strict
        self.allowlist = frozenset(
            DEFAULT_HOST_SYNC_ALLOWLIST if host_sync_allowlist is None
            else host_sync_allowlist)
        self._seen: Set[Tuple] = set()
        self._counters: Dict[str, int] = {
            "retraces": 0,
            "transfer_guard_trips": 0,
            "invariant_checks": 0,
            "allowed_host_syncs": 0,
            "compiles": 0,
        }

    # -- retrace guard ------------------------------------------------------
    @contextlib.contextmanager
    def expect_cached(self, sig: Tuple) -> Iterator[None]:
        """Scope one dispatch with signature ``sig``: a kernel build inside
        it is free the first time ``sig`` builds (warm-up) and a retrace
        every later time (module docstring: not yet possible)."""
        before = build.compile_events()
        try:
            yield
        finally:
            compiled = build.compile_events() - before
            if compiled:
                self._counters["compiles"] += compiled
                if sig in self._seen:
                    self._counters["retraces"] += 1
                    if self.strict:
                        raise SanitizeError(
                            f"retrace: a kernel was built again for the "
                            f"signature {sig[0]!r} already seen; a steady "
                            "step must reuse what it built")
                self._seen.add(sig)

    # -- host-sync guard ----------------------------------------------------
    @contextlib.contextmanager
    def no_host_sync(self, scope: str) -> Iterator[None]:
        """Forbid device-to-host reads inside the scope, except through
        :func:`host_read` with an allowlisted reason; on a card, under
        ``set_sync_debug_mode("error")``."""
        stack = _guard_stack()
        stack.append((self, scope))
        card = (_sync_debug_mode("error") if torch.cuda.is_available()
                else contextlib.nullcontext())
        try:
            with card:
                yield
        finally:
            stack.pop()

    def _on_host_read(self, reason: str, scope: str) -> None:
        if reason in self.allowlist:
            self._counters["allowed_host_syncs"] += 1
            return
        self._counters["transfer_guard_trips"] += 1
        if self.strict:
            raise SanitizeError(
                f"host sync {reason!r} inside no_host_sync scope "
                f"{scope!r}; allowlist={sorted(self.allowlist)}")

    # -- allocator invariants ----------------------------------------------
    def check_allocator(self, alloc: Any, *, drained: bool = False) -> None:
        self._counters["invariant_checks"] += 1
        try:
            alloc.check_invariants(drained=drained)
        except ValueError as e:
            raise SanitizeError(f"allocator invariant violated: {e}") from e

    # -- reporting ----------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return dict(self._counters)

    @property
    def clean(self) -> bool:
        return (self._counters["retraces"] == 0
                and self._counters["transfer_guard_trips"] == 0)
