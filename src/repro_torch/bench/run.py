"""Benchmark harness of the port: one module per paper figure (port of
``benchmarks/run.py``).

Prints ``name,ms,derived`` rows.  ``--full`` runs the reference's full
sizes (default: its quick ones); ``--device`` chooses the card (default)
or the CPU; ``--json PATH`` writes each module's rows, with the schema
version ``repro_torch.perf`` reads and the card's name and power limit.  A module that
raises is reported and the others still run; the harness then exits 1.

| module                 | paper figure/table |
|------------------------|--------------------|
| gemm_roofline          | Fig 4, 5, 7        |
| stream                 | Fig 8 / Alg 1      |
| gather_scatter         | Fig 9              |
| embedding_tables       | Fig 15 (S4.1)      |
| paged_attention_bench  | Fig 17 a-c (S4.2)  |
| recsys_e2e             | Fig 11 / Table 3   |

The reference's ``trace_replay`` and ``disagg`` modules run on their own
(``python -m repro_torch.bench.trace_replay``, ``python -m
repro_torch.bench.disagg``); its ``--backend``, ``--policy``, ``--spec``
and ``--devices`` sweeps, and its ``collectives``, ``llm_e2e`` and
``saturation`` modules, wait for the slices that port what they sweep.

    python -m repro_torch.bench.run [--only stream,gather_scatter] [--full]
        [--device cpu] [--json out.json]
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
import traceback
from typing import Callable, Dict, List

from repro_torch import device as device_lib
from repro_torch.bench.common import device_name
from repro_torch.bench.turns import card_line
from repro_torch.perf.table import SCHEMA_VERSION

MODULES = ("gemm_roofline", "stream", "gather_scatter", "embedding_tables",
           "paged_attention_bench", "recsys_e2e")


def runner(name: str) -> Callable[..., List[Dict[str, object]]]:
    """``fn(device, full)`` running module ``name`` once; returns its
    rows."""
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    return lambda dev, full: mod.run(dev, quick=not full)


def main(argv=None) -> List[Dict[str, object]]:
    """Run the modules; returns ``[{"module", "device", "full", "rows"}]``
    (as ``--json`` writes it)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("--only", default=None,
                    help="comma-separated modules (default: all)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="write each module's rows to this path")
    args = ap.parse_args(argv)
    mods = args.only.split(",") if args.only else list(MODULES)
    unknown = sorted(set(mods) - set(MODULES))
    if unknown:
        raise SystemExit(f"--only: unknown module(s) {unknown}; the port "
                         f"has {list(MODULES)}")
    dev = device_lib.resolve(args.device)
    # the card's name and power limit (nvidia-smi), or "cpu"
    card = card_line() if dev.type == "cuda" else "cpu"
    print("name,ms,derived", flush=True)
    results, failures = [], 0
    for m in mods:
        t0 = time.perf_counter()
        try:
            rows = runner(m)(dev, args.full)
        except Exception:
            traceback.print_exc()
            failures += 1
            rows = []
        results.append({"module": m, "schema_version": SCHEMA_VERSION,
                        "device": device_name(dev), "card": card,
                        "full": args.full, "rows": rows})
        print(f"# {m} done in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(f"# wrote {args.json}", file=sys.stderr)
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
