"""Trace replay and performance attribution of the port (a copy of
``repro.perf`` without the autotune table):

* :mod:`repro_torch.perf.trace`  — seeded synthetic request traces
  (bursty / shared-prefix / long-tail / mixed), JSON load/save and the
  prompt-length-bucketed decode-length model;
* :mod:`repro_torch.perf.replay` — feeds a serving engine from trace
  arrivals in virtual time (one engine step = one tick) and scores the run
  against p99 TTFT/TPOT SLOs;
* :mod:`repro_torch.perf.table`  — the measured perf table keyed by
  (scenario, config), the winner the ``auto`` policy triple resolves to,
  and the thread-local replay context;
* :mod:`repro_torch.perf.gate`   — the regression gate:
  ``python -m repro_torch.perf.gate --baseline BENCH_009.json --current
  new.json --threshold 0.2``.
"""
from repro_torch.perf.table import (SCHEMA_VERSION, PerfTable, SchemaError,
                              perf_context)
from repro_torch.perf.trace import LengthModel, Trace, TraceRequest, generate

__all__ = ["SCHEMA_VERSION", "PerfTable", "SchemaError", "perf_context",
           "Trace", "TraceRequest", "LengthModel", "generate"]
