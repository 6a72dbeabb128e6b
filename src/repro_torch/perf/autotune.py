"""The measured kernel-tunable table keyed by (page_size, head_dim, backend)
(port of ``repro.perf.autotune``).

``repro_torch.bench.paged_attention_bench`` sweeps the ragged kernel's
tunables (``num_queries_per_block``, ``num_kv_pages_per_block``,
``vmem_limit_bytes``: what each means on the card is in
``repro_torch.core.attention_api``) over a grid that always holds the
port's defaults, times every point on the same step mix, and emits one row
per point with ``tune=1`` in its derived string; the fastest point of each
``(page_size, head_dim, backend)`` cell also carries ``best=1``.  Written by
``python -m repro_torch.bench.run --only paged_attention_bench --json
PATH`` on the card and committed as ``repro_torch/perf/data/
tune_h100.json``, those rows are the table this module reads back.

``backend`` is the name of the kernel the engine's device runs, as
``metrics()["backend"]`` says it: ``cuda`` (the hand-written kernel) or
``plain`` (its PyTorch version on the CPU).  The table is looked up in the
environment variable ``REPRO_TORCH_TUNE_TABLE``, then in the packaged
``tune_h100.json``; never in the reference's ``BENCH_010.json``, whose times
were taken in Pallas interpret mode on a CPU under JAX backend names.

The serving engine calls :func:`resolve_tunables` when it is built, for
any tunable its config leaves at 0: a hit counts ``tuned_resolved``, a
miss ``tuned_fallback`` to the port's defaults.  A miss, or a file that is
absent or unreadable, gives None and never raises.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.perf.table import check_schema, parse_derived

__all__ = ["TUNABLE_KEYS", "TuneTable", "default_tune_table_path",
           "active_tune_table", "resolve_tunables"]

TUNABLE_KEYS = ("num_queries_per_block", "num_kv_pages_per_block",
                "vmem_limit_bytes")

PACKAGED_TUNE_TABLE = Path(__file__).resolve().parent / "data" / \
    "tune_h100.json"
_ENV_TUNE_TABLE = "REPRO_TORCH_TUNE_TABLE"

Key = Tuple[int, int, str]


class TuneTable:
    """Best measured tunables per (page_size, head_dim, backend)."""

    def __init__(self, best: Dict[Key, Dict[str, int]]):
        self.best = best

    @classmethod
    def from_results(cls, results: List[Dict], *,
                     origin: str = "<in-memory>") -> "TuneTable":
        """From benchmark JSON results (the list ``bench.run`` writes)."""
        best: Dict[Key, Dict[str, int]] = {}
        for result in results:
            if result.get("module") != "paged_attention_bench":
                continue
            check_schema(result, origin)
            for row in result.get("rows", []):
                d = parse_derived(row.get("derived", ""))
                if d.get("tune") != "1" or d.get("best") != "1":
                    continue
                try:
                    key = (int(d["page_size"]), int(d["head_dim"]),
                           d["backend"])
                    cfg = {k: int(d[k]) for k in TUNABLE_KEYS}
                except (KeyError, ValueError):
                    continue          # a malformed row: never half-resolve
                best[key] = cfg
        return cls(best)

    @classmethod
    def load(cls, path: str) -> "TuneTable":
        with open(path) as f:
            results = json.load(f)
        return cls.from_results(results, origin=path)

    def lookup(self, page_size: int, head_dim: int,
               backend: str) -> Optional[Dict[str, int]]:
        return self.best.get((int(page_size), int(head_dim), str(backend)))


def default_tune_table_path() -> Optional[str]:
    """The environment's table, else the packaged one, else None."""
    env = os.environ.get(_ENV_TUNE_TABLE)
    if env:
        return env
    return str(PACKAGED_TUNE_TABLE) if PACKAGED_TUNE_TABLE.exists() else None


_TABLE_CACHE: Dict[Tuple[str, float], TuneTable] = {}


def active_tune_table(path: Optional[str] = None) -> Optional[TuneTable]:
    """The table at ``path`` (default :func:`default_tune_table_path`);
    None where there is none or it cannot be read."""
    path = path or default_tune_table_path()
    if path is None:
        return None
    try:
        key = (path, os.path.getmtime(path))
        if key not in _TABLE_CACHE:
            _TABLE_CACHE[key] = TuneTable.load(path)
        return _TABLE_CACHE[key]
    except (OSError, ValueError):   # unreadable / incompatible: no table
        return None


def resolve_tunables(page_size: int, head_dim: int, backend: str,
                     path: Optional[str] = None) -> Optional[Dict[str, int]]:
    """The measured best tunables of this cell, or None on any miss."""
    table = active_tune_table(path)
    if table is None:
        return None
    return table.lookup(page_size, head_dim, backend)
