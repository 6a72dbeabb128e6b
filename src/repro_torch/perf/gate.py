"""Perf-regression gate: diff trace-replay rows on deterministic counters
(port of ``repro.perf.gate``, same columns, thresholds and exit codes).

Usage::

    python -m repro_torch.perf.gate --baseline BENCH_009.json \
        --current new.json --threshold 0.2

Both files are benchmark JSON in the reference schema (the reference's
``benchmarks/run.py`` or ``python -m repro_torch.bench.trace_replay
--json``).  Rows are matched by name, one (scenario, config) cell each, and
only deterministic counters are compared — steps, p99 TTFT/TPOT in steps,
tokens per step, prefix hits, finished/emitted totals; never wall clock.

Exit codes: 0 clean, 1 regression (or nothing comparable), 2 usage/schema
error: every trace_replay result in both files must carry
``schema_version == repro_torch.perf.table.SCHEMA_VERSION``.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.perf.table import SchemaError, check_schema, parse_derived

__all__ = ["GATE_COLUMNS", "Column", "Regression", "collect_rows", "compare",
           "main"]


@dataclass(frozen=True)
class Column:
    """One gated counter: which direction is a regression, noise floor."""

    name: str
    direction: str  # "up" = increase is bad, "down" = decrease is bad,
    #                 "exact" = any change is a workload-drift failure
    min_abs: float  # ignore absolute moves smaller than this (tiny integers)


GATE_COLUMNS: Tuple[Column, ...] = (
    Column("steps", "up", 2.0),
    Column("p99_ttft_steps", "up", 2.0),
    Column("p99_tpot_steps", "up", 0.5),
    Column("tok_per_step", "down", 0.05),
    Column("prefix_hits", "down", 2.0),
    Column("finished", "exact", 0.0),
    Column("out_tokens", "exact", 0.0),
)


@dataclass
class Regression:
    row: str
    column: str
    baseline: float
    current: float
    rel: float

    def __str__(self) -> str:
        return (f"{self.row}: {self.column} {self.baseline:g} -> "
                f"{self.current:g} ({self.rel:+.1%})")


def collect_rows(results: List[Dict], origin: str) -> Dict[str, Dict[str, str]]:
    """name -> parsed derived dict, for every trace_replay row.

    Raises SchemaError when any trace_replay result is missing or mismatched
    on schema_version (the shared check from repro_torch.perf.table).
    """
    rows: Dict[str, Dict[str, str]] = {}
    for result in results:
        if result.get("module") != "trace_replay":
            continue
        check_schema(result, origin)
        for row in result.get("rows", []):
            d = parse_derived(row.get("derived", ""))
            if "scenario" in d:
                rows[row.get("name", "")] = d
    return rows


def _value(row: Dict[str, str], col: str) -> Optional[float]:
    raw = row.get(col)
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def compare(baseline: Dict[str, Dict[str, str]],
            current: Dict[str, Dict[str, str]],
            threshold: float) -> Tuple[List[Regression], List[str]]:
    """Diff the rows present in both files; return (regressions, compared)."""
    regressions: List[Regression] = []
    compared = sorted(set(baseline) & set(current))
    for name in compared:
        b_row, c_row = baseline[name], current[name]
        for col in GATE_COLUMNS:
            b = _value(b_row, col.name)
            c = _value(c_row, col.name)
            if b is None or c is None:
                continue
            delta = c - b
            if col.direction == "exact":
                if delta != 0:
                    regressions.append(Regression(name, col.name, b, c,
                                                  delta / b if b else 1.0))
                continue
            worse = delta if col.direction == "up" else -delta
            if worse <= col.min_abs:
                continue
            rel = worse / max(abs(b), 1e-9)
            if rel > threshold:
                regressions.append(
                    Regression(name, col.name, b, c,
                               rel if col.direction == "up" else -rel))
    return regressions, compared


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.perf.gate",
        description="Fail when pinned trace-replay scenarios regress on "
                    "deterministic counters.")
    ap.add_argument("--baseline", required=True,
                    help="committed benchmark JSON (e.g. BENCH_009.json)")
    ap.add_argument("--current", required=True,
                    help="freshly generated benchmark JSON to check")
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="max tolerated relative regression (default 0.2)")
    args = ap.parse_args(argv)

    try:
        with open(args.baseline) as f:
            base_rows = collect_rows(json.load(f), args.baseline)
        with open(args.current) as f:
            cur_rows = collect_rows(json.load(f), args.current)
    except SchemaError as e:
        print(f"perf-gate: SCHEMA REFUSED: {e}", file=sys.stderr)
        return 2
    except (OSError, json.JSONDecodeError) as e:
        print(f"perf-gate: cannot read inputs: {e}", file=sys.stderr)
        return 2

    regressions, compared = compare(base_rows, cur_rows, args.threshold)
    missing = sorted(set(base_rows) - set(cur_rows))
    if not compared:
        print("perf-gate: FAIL: no comparable trace-replay rows between "
              f"{args.baseline} and {args.current}", file=sys.stderr)
        return 1
    print(f"perf-gate: compared {len(compared)} pinned rows "
          f"(threshold {args.threshold:.0%}; "
          f"{len(missing)} baseline-only rows skipped)")
    if regressions:
        print(f"perf-gate: FAIL: {len(regressions)} regression(s):",
              file=sys.stderr)
        for r in regressions:
            print(f"  {r}", file=sys.stderr)
        return 1
    print("perf-gate: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
