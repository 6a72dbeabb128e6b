"""The measured perf table keyed by (scenario, config) + the replay context
(port of ``repro.perf.table``).

A trace-replay sweep emits rows whose ``derived`` string carries scenario,
policy triple, spec/overlap config, SLO verdict and the deterministic
counters of :meth:`repro_torch.perf.replay.ReplayResult.counters`.  This
module parses those rows out of benchmark JSON (the committed
``BENCH_009.json``) into a :class:`PerfTable` and answers the question the
``auto`` policy triple asks at engine construction: which registered triple
won this scenario?  The objective: SLO met first, then p99 TTFT steps, p99
TPOT steps, total steps, and the triple string as the tie-break.

The thread-local replay context (:func:`perf_context`) tells policies built
inside it the active scenario (the table key) and the
:class:`~repro_torch.perf.trace.LengthModel` that ``predicted-length``
admission reads.  Environment fallbacks: ``REPRO_PERF_SCENARIO`` and
``REPRO_PERF_TABLE``; without either, the table is ``BENCH_009.json`` in
the working directory or at the repo root, as in the reference.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["SCHEMA_VERSION", "SchemaError", "PerfTable", "parse_derived",
           "check_schema", "perf_context", "active_scenario", "active_table",
           "active_length_model", "resolve_winner", "default_table_path"]

# Version of the benchmark-JSON result schema (result-level provenance keys +
# the derived-row grammar the gate and this table parse). Bump on any
# incompatible change; repro.perf.gate refuses to diff mismatched versions.
SCHEMA_VERSION = 1

DEFAULT_TABLE_NAME = "BENCH_009.json"
_ENV_TABLE = "REPRO_PERF_TABLE"
_ENV_SCENARIO = "REPRO_PERF_SCENARIO"

AXES = ("admission", "preemption", "eviction")


class SchemaError(ValueError):
    """Benchmark JSON has a missing or incompatible schema_version."""


def parse_derived(derived: str) -> Dict[str, str]:
    """Parse a benchmark row's ``k=v;k=v`` derived string into a dict."""
    out: Dict[str, str] = {}
    for part in (derived or "").split(";"):
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip()
    return out


def check_schema(result: Dict, origin: str) -> None:
    version = result.get("schema_version")
    if version != SCHEMA_VERSION:
        raise SchemaError(
            f"{origin}: trace_replay result has schema_version={version!r}, "
            f"this build supports {SCHEMA_VERSION}")


class PerfTable:
    """Parsed trace-replay rows with per-scenario winner resolution."""

    def __init__(self, rows: List[Dict[str, str]]):
        # Keep only rows that carry full (scenario, triple) attribution.
        self.rows = [r for r in rows
                     if r.get("scenario") and all(r.get(a) for a in AXES)]

    @classmethod
    def from_results(cls, results: List[Dict], *,
                     origin: str = "<in-memory>") -> "PerfTable":
        """Build from benchmark-JSON results (a list of modules' results)."""
        rows: List[Dict[str, str]] = []
        for result in results:
            if result.get("module") != "trace_replay":
                continue
            check_schema(result, origin)
            for row in result.get("rows", []):
                d = parse_derived(row.get("derived", ""))
                d.setdefault("name", row.get("name", ""))
                rows.append(d)
        return cls(rows)

    @classmethod
    def load(cls, path: str) -> "PerfTable":
        with open(path) as f:
            results = json.load(f)
        return cls.from_results(results, origin=path)

    def scenarios(self) -> List[str]:
        return sorted({r["scenario"] for r in self.rows})

    @staticmethod
    def objective(row: Dict[str, str]) -> Tuple:
        """Deterministic goodness: lower is better, triple string tie-break."""
        triple = "/".join(row.get(a, "") for a in AXES)
        return (0 if row.get("slo_ok") == "1" else 1,
                float(row.get("p99_ttft_steps", "inf")),
                float(row.get("p99_tpot_steps", "inf")),
                float(row.get("steps", "inf")),
                triple)

    def comparable_rows(self, scenario: str) -> List[Dict[str, str]]:
        """Fixed-triple rows for ``scenario`` at the baseline config.

        Spec/overlap/multi-device variants and ``auto`` rows are excluded:
        the winner must be a concrete triple measured under the same config
        ``auto`` runs at.
        """
        return [r for r in self.rows
                if r.get("scenario") == scenario
                and r.get("spec", "off") == "off"
                and r.get("overlap", "off") == "off"
                and r.get("devices", "1") == "1"
                and "auto" not in tuple(r.get(a) for a in AXES)]

    def winner(self, scenario: str) -> Optional[Dict[str, str]]:
        """Best policy triple for ``scenario``: {axis: name}, or None."""
        rows = self.comparable_rows(scenario)
        if not rows:
            return None
        best = min(rows, key=self.objective)
        return {a: best[a] for a in AXES}

    def best_objective(self, scenario: str) -> Optional[Tuple]:
        rows = self.comparable_rows(scenario)
        return min(map(self.objective, rows)) if rows else None


# ---------------------------------------------------------------------------
# Active replay context (thread-local, env fallback)

_STATE = threading.local()


def _ctx_stack() -> List[Dict]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


class perf_context:
    """Scope declaring the workload for policies constructed inside it.

    Engines resolve their policy triple at construction, so wrap the engine
    *constructor* (not just the replay) when using ``auto`` or
    ``predicted-length``::

        with perf_context(scenario=trace.scenario, table=table,
                          length_model=model):
            engine = ServingEngine(...)
    """

    def __init__(self, *, scenario: Optional[str] = None,
                 table: Optional[PerfTable] = None,
                 length_model=None):
        self._frame = {"scenario": scenario, "table": table,
                       "length_model": length_model}

    def __enter__(self):
        _ctx_stack().append(self._frame)
        return self

    def __exit__(self, *exc):
        _ctx_stack().pop()
        return False


def _lookup(key: str):
    for frame in reversed(_ctx_stack()):
        if frame.get(key) is not None:
            return frame[key]
    return None


def active_scenario() -> Optional[str]:
    return _lookup("scenario") or os.environ.get(_ENV_SCENARIO) or None


def active_length_model():
    return _lookup("length_model")


def default_table_path() -> Optional[str]:
    """Committed-table lookup: env override, cwd, then the repo checkout."""
    env = os.environ.get(_ENV_TABLE)
    if env:
        return env
    cwd_path = os.path.join(os.getcwd(), DEFAULT_TABLE_NAME)
    if os.path.exists(cwd_path):
        return cwd_path
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    repo_path = os.path.join(repo, DEFAULT_TABLE_NAME)
    if os.path.exists(repo_path):
        return repo_path
    return None


_TABLE_CACHE: Dict[Tuple[str, float], PerfTable] = {}


def active_table() -> Optional[PerfTable]:
    """The context's table, else the committed default (None on any miss)."""
    tab = _lookup("table")
    if tab is not None:
        return tab
    path = default_table_path()
    if path is None:
        return None
    try:
        key = (path, os.path.getmtime(path))
        if key not in _TABLE_CACHE:
            _TABLE_CACHE[key] = PerfTable.load(path)
        return _TABLE_CACHE[key]
    except (OSError, ValueError):  # unreadable/incompatible file = no table
        return None


def resolve_winner(axis: str) -> Optional[str]:
    """Winning policy name for ``axis`` under the active (scenario, table).

    Returns None — the caller falls back to defaults with a counted
    ``auto_fallback`` — when there is no active scenario, no table, or the
    table has no comparable rows for the scenario.
    """
    scenario = active_scenario()
    if scenario is None:
        return None
    table = active_table()
    if table is None:
        return None
    triple = table.winner(scenario)
    if triple is None:
        return None
    return triple.get(axis)
