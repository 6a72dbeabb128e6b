"""Benchmark harness of the port: one module per paper figure (port of
``benchmarks/run.py``).

Prints ``name,ms,derived`` rows.  ``--full`` runs the reference's full
sizes (default: its quick ones); ``--device`` chooses the card (default)
or the CPU; ``--json PATH`` writes each pass's rows with the schema
version ``repro_torch.perf`` reads, the commit and the card's name and
power limit.  A module that raises is reported and the others still run;
the harness then exits 1.

| module                 | paper figure/table |
|------------------------|--------------------|
| gemm_roofline          | Fig 4, 5, 7        |
| stream                 | Fig 8 / Alg 1      |
| gather_scatter         | Fig 9              |
| embedding_tables       | Fig 15 (S4.1)      |
| paged_attention_bench  | Fig 17 a-c (S4.2)  |
| recsys_e2e             | Fig 11 / Table 3   |
| llm_e2e                | Fig 12, 17 d-e     |
| saturation             | S4.2 pipeline      |
| disagg                 | S4.2 disaggregation|
| trace_replay           | S5 trace replay / SLO sweep |

``--policy adm/pre/evi,...`` repeats the run once per serving-policy
triple, each pass under ``serving.policy.force_policies``, so every engine
built in it runs that triple (an empty axis, ``//lru``, keeps its
default); only the modules in ``POLICY_SENSITIVE`` (those that build
engines) repeat, the others run once, under the first triple.  ``--spec
off,ngram,...`` does the same for the speculative proposer
(``serving.spec.force_proposer``, ``SPEC_SENSITIVE``).  Names are checked
before any module runs.  Each row is stamped with the triple and proposer
that the pass's engines resolved (``policy``, ``spec``) and with
``sanitize`` (``REPRO_SANITIZE=1``).  ``trace_replay`` sweeps its own
triples with explicit arguments, which outrank a scope, so it is not
policy-sensitive.

Not ported: ``--backend`` (the port has no op registry: each kernel
follows the device of its tensors, ``--device``) and ``--devices`` and the
``collectives`` module, which wait for multi-card support; both flags are
refused.

    python -m repro_torch.bench.run [--only llm_e2e,saturation] [--full]
        [--policy fcfs/latest-arrival/lru,...] [--spec off,ngram]
        [--device cpu] [--json out.json]
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List

from repro_torch import device as device_lib
from repro_torch.bench.common import device_name
from repro_torch.bench.turns import card_line
from repro_torch.perf.table import SCHEMA_VERSION
from repro_torch.serving import policy as policy_lib
from repro_torch.serving import spec as spec_lib

MODULES = ("gemm_roofline", "stream", "gather_scatter", "embedding_tables",
           "paged_attention_bench", "recsys_e2e", "llm_e2e", "saturation",
           "disagg", "trace_replay")
# modules that build serving engines: the only ones whose numbers can
# depend on the policy triple or the proposer
POLICY_SENSITIVE = {"llm_e2e", "saturation", "disagg"}
SPEC_SENSITIVE = {"llm_e2e"}
MULTI_CARD = "waits for the port's multi-card support"
REFUSED = {
    "--backend": "the port has no backend registry: each kernel follows "
                 "the device of its tensors (--device)",
    "--devices": f"the device-count sweep {MULTI_CARD}",
}


def _disagg(dev, full):
    """``bench.disagg`` as its ``main`` builds it: llama31-8b at full
    width with ``--full``, else the reference's model at its quick or
    smoke sizes."""
    from repro_torch.bench import disagg
    from repro_torch.bench.trace_replay import build

    if full:
        cfg, model, params = build("llama31-8b", False, dev)
        sizes = disagg.FULL
    else:
        cfg, model, params = build("smollm-360m", True, dev)
        sizes = (disagg.SMOKE if os.environ.get("REPRO_BENCH_SMOKE")
                 else disagg.QUICK)
    return disagg.run(model, params, cfg, device=dev, sizes=sizes)


def _trace_replay(dev, full):
    """``bench.trace_replay`` on the reference's model and weights (its
    ``--reduced``), every scenario, or ``mixed`` alone under smoke."""
    from repro_torch.bench import trace_replay

    cfg, model, params = trace_replay.build("smollm-360m", True, dev)
    scenarios = (("mixed",) if os.environ.get("REPRO_BENCH_SMOKE")
                 else tuple(trace_replay.SCENARIOS))
    records = trace_replay.sweep(model, params, cfg, scenarios=scenarios,
                                 device=dev)
    return [{"name": r["name"], "ms": r["us_per_call"] / 1e3,
             "derived": r["derived"], "seed": r["seed"],
             "policy": r["policy"]} for r in records]


_ADAPTERS = {"disagg": _disagg, "trace_replay": _trace_replay}


def runner(name: str) -> Callable[..., List[Dict[str, object]]]:
    """``fn(device, full)`` running module ``name`` once; returns its
    rows."""
    if name in _ADAPTERS:
        return _ADAPTERS[name]
    mod = importlib.import_module(f"repro_torch.bench.{name}")
    return lambda dev, full: mod.run(dev, quick=not full)


def git_commit() -> str:
    """The checkout's short commit hash, or "unknown" (a tarball)."""
    repo = Path(__file__).resolve().parents[3]
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=repo, capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    commit = out.stdout.strip()
    return commit if out.returncode == 0 and commit else "unknown"


def parse_spec_names(arg: str) -> List[str]:
    """``off,ngram,draft-model`` -> canonical proposer names (checked)."""
    out = []
    for name in arg.split(","):
        name = name.strip()
        if name != spec_lib.OFF:
            try:
                name = spec_lib.get(name).name
            except spec_lib.UnknownProposerError as e:
                raise SystemExit(f"--spec: {e}") from None
        out.append(name)
    return out


def parse_policy_triples(arg: str) -> List[Dict[str, object]]:
    """``adm/pre/evi,...`` -> one per-axis dict a triple (names checked,
    an empty axis None)."""
    triples = []
    for spec in arg.split(","):
        parts = spec.split("/")
        if len(parts) != 3:
            raise SystemExit(f"--policy: expected admission/preemption/"
                             f"eviction, got {spec!r}")
        triple = {}
        for axis, name in zip(policy_lib.AXES, parts):
            if name:
                try:
                    policy_lib.get(axis, name)
                except policy_lib.UnknownPolicyError as e:
                    raise SystemExit(f"--policy: {e}") from None
            triple[axis] = name or None
        triples.append(triple)
    return triples


def resolved_triple(plog) -> str:
    """The triple a pass resolved, from its resolution log."""
    by_axis: Dict[str, set] = {}
    for axis, name in plog:
        by_axis.setdefault(axis, set()).add(name)
    return "/".join(
        "/".join(sorted(by_axis[a])) if a in by_axis
        else policy_lib.DEFAULTS[a] for a in policy_lib.AXES)


def main(argv=None) -> List[Dict[str, object]]:
    """Run the modules; returns one record a (module, pass), as ``--json``
    writes them."""
    argv = sys.argv[1:] if argv is None else list(argv)
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in REFUSED:
            raise SystemExit(f"{flag}: not ported: {REFUSED[flag]}")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 allow_abbrev=False)
    ap.add_argument("--only", default=None,
                    help="comma-separated modules (default: all)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="comma-separated admission/preemption/eviction "
                         "triples, one pass each")
    ap.add_argument("--spec", default=None,
                    help="comma-separated proposers (off, ngram, "
                         "draft-model), one pass each")
    ap.add_argument("--json", default=None,
                    help="write each pass's rows to this path")
    args = ap.parse_args(argv)
    mods = args.only.split(",") if args.only else list(MODULES)
    unknown = sorted(set(mods) - set(MODULES))
    if unknown:
        raise SystemExit(f"--only: unknown module(s) {unknown}; the port "
                         f"has {list(MODULES)}")
    policies = (parse_policy_triples(args.policy) if args.policy
                else [None])
    specs = parse_spec_names(args.spec) if args.spec else [None]
    dev = device_lib.resolve(args.device)
    # the card's name and power limit (nvidia-smi), or "cpu"
    card = card_line() if dev.type == "cuda" else "cpu"
    commit = git_commit()
    sanitized = os.environ.get("REPRO_SANITIZE") == "1"
    print("name,ms,derived", flush=True)
    results, failures = [], 0
    for (pi, pol), (si, spc) in itertools.product(enumerate(policies),
                                                  enumerate(specs)):
        pol_kwargs = {a: (pol or {}).get(a) for a in policy_lib.AXES}
        pol_str = ("/".join(pol_kwargs[a] or policy_lib.DEFAULTS[a]
                            for a in policy_lib.AXES)
                   if pol is not None else None)
        for m in mods:
            if pi > 0 and m not in POLICY_SENSITIVE:
                continue               # policy-blind: one pass is enough
            if si > 0 and m not in SPEC_SENSITIVE:
                continue               # proposer-blind: ditto
            t0 = time.perf_counter()
            plog, slog = [], []
            try:
                with policy_lib.force_policies(**pol_kwargs), \
                        policy_lib.record_resolutions() as plog, \
                        spec_lib.force_proposer(spc), \
                        spec_lib.record_resolutions() as slog:
                    rows = runner(m)(dev, args.full)
            except Exception:
                traceback.print_exc()
                failures += 1
                rows = []
            resolved_pol = resolved_triple(plog) if plog else None
            resolved_spec = (slog[0] if len(set(slog)) == 1 else None)
            for r in rows:
                # a row that names its own triple (trace_replay) keeps it
                if resolved_pol:
                    r.setdefault("policy", resolved_pol)
                if resolved_spec:
                    r.setdefault("spec", resolved_spec)
                r["sanitize"] = sanitized
            results.append({
                "module": m, "schema_version": SCHEMA_VERSION,
                "git_commit": commit, "device": device_name(dev),
                "card": card, "full": args.full,
                "requested_policy": pol_str or "default",
                "requested_spec": spc or "default", "sanitize": sanitized,
                "resolved_policies": sorted({f"{ax}={nm}"
                                             for ax, nm in plog}),
                "resolved_spec": sorted(set(slog)), "rows": rows})
            print(f"# {m} done in {time.perf_counter() - t0:.1f}s"
                  + (f" [policy={pol_str}]" if pol_str else "")
                  + (f" [spec={spc}]" if spc else ""),
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
