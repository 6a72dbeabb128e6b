"""Trace-replay SLO sweep of the port (port of the reference's
``benchmarks/trace_replay.py``, its single-device configurations).

Replays the pinned synthetic traces (:mod:`repro_torch.perf.trace`:
bursty / shared-prefix / long-tail / mixed, fixed seeds and sizes) through
the port's serving engine under seven configurations: three fixed policy
triples, ``predicted-length`` admission, the ``ngram`` proposer, the
overlapped loop, and last ``auto``, resolved from the table built in this
run from the fixed rows.  Each row's ``derived`` string carries the
(scenario, config) attribution, the SLO verdict and the deterministic
replay counters that :mod:`repro_torch.perf.gate` diffs; the reference's
``dev2`` row (two devices) is not run.  The module asserts, as the
reference does, that ``auto`` resolved on every axis and that its
objective is no worse than the best fixed triple's.

    python -m repro_torch.bench.trace_replay --device cpu --reduced \\
        --json pt.json
    python -m repro_torch.perf.gate --baseline BENCH_009.json --current pt.json

``--reduced`` runs the reduced float32 smollm-360m of ``BENCH_009.json``
with the reference's own weights (:data:`REFERENCE_WEIGHTS`, the JAX
model's ``init(PRNGKey(0))`` saved as numpy), so every row can be held to
the committed table field for field; otherwise the weights come from the
port's seeded generator.  :func:`sweep` can add a ``draft-model`` row
per scenario (not part of the reference's table).  Every row's pool must
drain with the allocator's invariants intact.

:data:`REFERENCE_CAVEATS` names the rows of ``BENCH_009.json`` that the
JAX package at this commit does not reproduce (ROADMAP queue C): a
comparison with the committed table takes those rows from a CPU run of the
port instead (:func:`baseline`).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from repro_torch.config import ServeConfig, get_config
from repro_torch.perf.replay import Slo, replay, score
from repro_torch.perf.table import (AXES, SCHEMA_VERSION, PerfTable,
                                   parse_derived, perf_context)
from repro_torch.perf.trace import LengthModel, generate
from repro_torch.serving.engine import ServingEngine

# Pinned scenarios, trace sizes and pool sizing: the reference's, so rows
# compare with BENCH_009.json by name.
SCENARIOS = {
    "bursty": dict(seed=101, n_requests=12, slo=Slo(ttft_s=1.5, tpot_s=0.3)),
    "shared-prefix": dict(seed=202, n_requests=12,
                          slo=Slo(ttft_s=1.5, tpot_s=0.3)),
    "long-tail": dict(seed=303, n_requests=12,
                      slo=Slo(ttft_s=1.5, tpot_s=0.35)),
    "mixed": dict(seed=404, n_requests=12, slo=Slo(ttft_s=1.5, tpot_s=0.3)),
}
TRACE_KWARGS = dict(prompt_hi=16, gen_cap=14)
NUM_BLOCKS = 10
MAX_BATCH = 3
KV_BLOCK_SIZE = 8
SPEC_K = 3

# (label, admission/preemption/eviction, spec, overlap): the reference's
# single-device configurations; auto runs last, against the table built
# from the rows above it.
FCFS = ("fcfs", "latest-arrival", "lru")
CONFIGS = [
    ("fcfs", FCFS, "off", False),
    ("prio", ("priority", "fewest-remaining-tokens", "hit-rate"), "off",
     False),
    ("edf", ("deadline-slo", "most-blocks", "refcount-aware"), "off", False),
    ("plen", ("predicted-length", "latest-arrival", "lru"), "off", False),
    ("ngram", FCFS, "ngram", False),
    ("overlap", FCFS, "off", True),
    ("auto", ("auto", "auto", "auto"), "off", False),
]
DRAFT_CONFIG = ("draft", FCFS, "draft-model", False)
BENCH_009 = Path(__file__).resolve().parents[3] / "BENCH_009.json"
REFERENCE_CAVEATS = ("trace_bursty_ngram", "trace_shared-prefix_ngram",
                     "trace_long-tail_ngram", "trace_mixed_ngram")

REFERENCE_WEIGHTS = (Path(__file__).resolve().parent / "data"
                     / "smollm_360m_reduced_f32_seed0.npz")


def load_weights(path, device) -> Dict:
    """The parameter tree saved flat in ``path`` (keys ``a/b/c``)."""
    from repro_torch.models.bridge import params_from_numpy

    tree: Dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return params_from_numpy(tree, device=device)


def trace_of(scenario: str, vocab_size: int):
    p = SCENARIOS[scenario]
    return generate(scenario, seed=p["seed"], n_requests=p["n_requests"],
                    vocab_size=vocab_size, **TRACE_KWARGS)


def run_one(model, params, cfg, scenario, trace, config, *, table,
            length_model, device, attn_impl="ragged"):
    """Replay ``trace`` through a fresh engine under ``config``; returns
    (engine, ReplayResult, SloReport, wall seconds)."""
    _, (adm, pre, evi), spec_name, overlap = config
    serve = ServeConfig(model=cfg.name, kv_block_size=KV_BLOCK_SIZE,
                        max_batch=MAX_BATCH, spec=spec_name, spec_k=SPEC_K,
                        overlap=overlap, attn_impl=attn_impl)
    with perf_context(scenario=scenario, table=table,
                      length_model=length_model):
        eng = ServingEngine(model, params, cfg, serve, num_blocks=NUM_BLOCKS,
                            admission=adm, preemption=pre, eviction=evi,
                            device=device)
    t0 = time.time()
    result = replay(eng, trace)
    dt = time.time() - t0
    return eng, result, score(result, SCENARIOS[scenario]["slo"]), dt


def derived_of(scenario, config, trace, result, report) -> str:
    """The reference's ``derived`` string of one row (devices=1)."""
    _, (adm, pre, evi), spec_name, overlap = config
    c = result.counters()
    period = trace.step_period
    return (
        f"scenario={scenario};admission={adm};preemption={pre};"
        f"eviction={evi};spec={spec_name};"
        f"overlap={'on' if overlap else 'off'};devices=1;"
        f"slo_ok={1 if report.ok else 0};"
        f"p99_ttft_steps={c['p99_ttft_steps']};"
        f"p99_tpot_steps={c['p99_tpot_steps']};"
        f"p99_ttft_vs={c['p99_ttft_steps'] * period:.3f};"
        f"p99_tpot_vs={c['p99_tpot_steps'] * period:.4f};"
        f"att_ttft={report.attainment_ttft};"
        f"att_tpot={report.attainment_tpot};"
        f"steps={c['steps']};finished={c['finished']};"
        f"out_tokens={c['out_tokens']};tok_per_step={c['tok_per_step']};"
        f"prefix_hits={c['prefix_hits']};preempt={c['preempt']};"
        f"idle_ff={c['idle_ff']}")


def sweep(model, params, cfg, *, scenarios=tuple(SCENARIOS), device="cuda",
          draft=(), log=print) -> List[Dict]:
    """Every configuration on every scenario (and ``draft-model`` on the
    scenarios in ``draft``).  Returns one record per row:
    the reference's ``name`` / ``us_per_call`` / ``derived`` / ``seed`` /
    ``policy``, plus ``outputs`` (req_id -> greedy stream), ``metrics``
    (the engine's) and ``slo`` (the SLO report, virtual seconds), which
    :func:`to_json` leaves out."""
    records = []
    for scenario in scenarios:
        trace = trace_of(scenario, cfg.vocab_size)
        length_model = LengthModel.fit(trace)
        fixed = []
        configs = CONFIGS[:-1] + ([DRAFT_CONFIG] if scenario in draft
                                  else [])
        for config in configs + [CONFIGS[-1]]:
            label, triple = config[0], config[1]
            table = None
            if label == "auto":
                table = PerfTable([parse_derived(r["derived"]) for r in fixed])
            eng, result, report, dt = run_one(
                model, params, cfg, scenario, trace, config, table=table,
                length_model=length_model, device=device)
            derived = derived_of(scenario, config, trace, result, report)
            eng.alloc.check_invariants(drained=True)
            m = eng.metrics()
            if label == "auto":
                winner = table.winner(scenario)
                derived += ";resolved=" + "/".join(winner[a] for a in AXES)
                _check_auto(scenario, m["policy_counters"], derived, table)
            rec = dict(name=f"trace_{scenario}_{label}", us_per_call=dt * 1e6,
                       derived=derived, seed=trace.seed,
                       policy="/".join(triple), outputs=result.outputs,
                       metrics=m, slo=report.as_dict())
            if label not in ("auto", "draft"):
                fixed.append(rec)
            records.append(rec)
            log(f"{rec['name']},{rec['us_per_call']:.1f},{derived}")
            del eng
    return records


def _check_auto(scenario, counters, derived, table) -> None:
    """The reference's asserts on the auto row: resolution (not fallback)
    counted on every axis, and an objective no worse than the best fixed
    triple's."""
    for axis in AXES:
        if counters.get(f"{axis}.auto_resolved", 0) < 1:
            raise AssertionError(f"{scenario}: auto did not resolve {axis}: "
                                 f"{counters}")
    auto_obj = PerfTable.objective(parse_derived(derived))
    best = table.best_objective(scenario)
    if not auto_obj[:4] <= best[:4]:
        raise AssertionError(f"{scenario}: auto {auto_obj} worse than the "
                             f"best fixed triple {best}")


def baseline(rows_instead: Dict[str, str], path=BENCH_009) -> List[Dict]:
    """``BENCH_009.json`` with the derived string of each caveat row
    replaced by ``rows_instead[name]`` (a run of the port)."""
    with open(path) as f:
        results = json.load(f)
    for r in results[0]["rows"]:
        if r["name"] in REFERENCE_CAVEATS:
            r["derived"] = rows_instead[r["name"]]
    return results


def to_json(records, **provenance) -> List[Dict]:
    """Benchmark JSON in the reference's schema (what the gate reads)."""
    keep = ("name", "us_per_call", "derived", "seed", "policy")
    return [{"module": "trace_replay", "schema_version": SCHEMA_VERSION,
             **provenance,
             "rows": [{k: r[k] for k in keep} for r in records]}]


def build(model_name: str, reduced: bool, device, seed: int = 0):
    """(cfg, model, params) of the sweep: the reduced float32 config with
    the reference's weights, or the full config with seeded weights."""
    from repro_torch.models.api import build_model

    cfg = get_config(model_name)
    if reduced:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg, device=device)
    params = (load_weights(REFERENCE_WEIGHTS, device) if reduced
              else model.init(seed))
    return cfg, model, params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.trace_replay")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--model", default="smollm-360m")
    p.add_argument("--reduced", action="store_true",
                   help="the reduced float32 config of BENCH_009.json, with "
                        "the reference's weights")
    p.add_argument("--json", default=None, help="write the rows here")
    args = p.parse_args(argv)
    cfg, model, params = build(args.model, args.reduced, args.device)
    records = sweep(model, params, cfg, device=args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(to_json(records, device=str(args.device),
                              model=cfg.name, dtype=cfg.dtype), f, indent=2)
        print(f"# wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
