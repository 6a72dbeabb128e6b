"""Serving launcher of the port: continuous batching over the paged KV
cache, attention through a hand-written CUDA kernel on a card (``--attn-impl
ragged`` or ``chunked``) —
``python -m repro_torch.launch.serve --arch smollm-360m --requests 8``.

``--spec ngram|draft-model --spec-k N`` turns on speculative decoding,
``--overlap on`` the overlapped engine loop; greedy streams are the same.
``--trace t.json`` replays a :mod:`repro_torch.perf.trace` JSON in virtual
time instead of the synthetic workload and prints the SLO scorecard
against ``--slo-ttft`` / ``--slo-tpot``; under a trace, ``auto`` policies
resolve from the committed ``BENCH_009.json`` for the trace's scenario and
``predicted-length`` learns from the trace.  ``--policy`` names all three
policy axes at once (one name, or ``admission/preemption/eviction``).
``--roles prefill,decode`` serves through the disaggregated two-role
frontend (:mod:`repro_torch.serving.disagg`) and ``--host-blocks N`` adds
the host-memory KV tier (pair it with ``--eviction tiered``).
``--num-queries-per-block``, ``--num-kv-pages-per-block`` and
``--vmem-limit-bytes`` pin the paged kernels' tunables (0, the default,
consults the measured table ``repro_torch/perf/data/tune_h100.json``
for the ragged kernel, then the port's defaults); ``--sanitize on`` runs
the engine under its runtime guards.  There is no ``--backend``: the
kernel follows ``--device``.  ``--arch`` takes the dense and MoE configs
(granite-moe-1b-a400m fits one card; qwen3-moe-235b-a22b only
``--reduced``).

``--devices N`` (N > 1) serves on a mesh of N ranks, one process each,
joined over gloo through a ``file://`` rendezvous in a temporary
directory (``repro_torch.launch.mesh.run_ranks``): rank r takes
``cuda:(r % device_count)``, every rank runs the whole host loop on the
same requests, the params are tensor-parallel and the KV pool
sequence-sharded over the ranks (``ServeConfig.devices``), and rank 0's
summary is printed (``attention=sharded devices=N mesh=...``); greedy
streams are the single-device run's.

Weights are random, drawn from a seeded generator on the device.  Pass
``--device cpu`` (with ``--reduced`` for a tiny float32 model) to run the
plain PyTorch path without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.perf import replay as replay_lib
from repro_torch.perf.table import perf_context
from repro_torch.perf.trace import LengthModel, Trace
from repro_torch.serving import policy as policy_lib
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Request, ServingEngine


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--reduced", action="store_true",
                   help="tiny float32 config of the same family")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attn-impl", default="ragged",
                   choices=("ragged", "chunked"),
                   help="attention kernel of every layer: 'ragged' (cu "
                        "prefix sums over the fused KV pool) or 'chunked' "
                        "(token lanes over its split views); greedy "
                        "streams are identical")
    p.add_argument("--q-chunk", type=int, default=16,
                   help="lanes per query tile of the chunked kernel")
    p.add_argument("--prefetch-depth", type=int, default=0,
                   help="the reference's KV-page DMA ring depth for the "
                        "chunked kernel; the CUDA kernel ignores it")
    p.add_argument("--num-queries-per-block", type=int, default=0,
                   help="ragged kernel: query rows (lanes x G) per "
                        "tensor-core tile, G to 128; 0 = autotune table / "
                        "default")
    p.add_argument("--num-kv-pages-per-block", type=int, default=0,
                   help="paged kernels: KV pages per decode split (whole "
                        "64-key stages, at most 512 keys); 0 = autotune "
                        "table / default")
    p.add_argument("--vmem-limit-bytes", type=int, default=0,
                   help="paged kernels: cap on a launch's shared memory in "
                        "bytes, refusing a launch that requests more; 0 = "
                        "autotune table / none")
    p.add_argument("--sanitize", default="off", choices=("on", "off"),
                   help="runtime guards: kernel rebuilds, host syncs in the "
                        "build half, allocator invariants after each "
                        "commit")
    for axis in policy_lib.AXES:
        p.add_argument(f"--{axis}", default=policy_lib.DEFAULTS[axis],
                       choices=policy_lib.names(axis),
                       help=f"serving {axis} policy")
    p.add_argument("--policy", default="",
                   help="one name for all three policy axes, or "
                        "'admission/preemption/eviction'; overrides the "
                        "per-axis flags")
    p.add_argument("--spec", default=spec_lib.OFF,
                   choices=spec_lib.names() + sorted(spec_lib.ALIASES),
                   help="speculative-decoding proposer; 'off' decodes one "
                        "token per request per step")
    p.add_argument("--spec-k", type=int, default=4,
                   help="max draft tokens per request per step")
    p.add_argument("--overlap", default="off", choices=("on", "off"),
                   help="overlapped engine loop: step n+1 is built and "
                        "dispatched before step n is resolved")
    p.add_argument("--trace", default="",
                   help="a trace JSON to replay in virtual time instead of "
                        "the synthetic workload")
    p.add_argument("--slo-ttft", type=float, default=1.0,
                   help="p99 TTFT target in virtual seconds (--trace)")
    p.add_argument("--slo-tpot", type=float, default=0.3,
                   help="p99 TPOT target in virtual seconds (--trace)")
    p.add_argument("--roles", default="",
                   help="'' = one engine; 'prefill,decode' (or 'split') = "
                        "disaggregated serving: prompts prefill on one "
                        "engine, their KV blocks are handed to the other, "
                        "which decodes")
    p.add_argument("--host-blocks", type=int, default=0,
                   help="host-memory KV tier in blocks (0 = none): evicted "
                        "cached-free blocks are demoted to a host LRU and "
                        "promoted back on a prefix hit; pair with "
                        "--eviction tiered")
    p.add_argument("--devices", type=int, default=1,
                   help="ranks of the serving mesh (one process each, "
                        "gloo); 1 = one device")
    return p


def main(argv=None) -> Dict:
    """Serve and print the summary; returns ``{"lines", "outputs",
    "metrics"}`` (rank 0's with ``--devices N``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = _parser()
    args = p.parse_args(argv)
    if args.devices < 1:
        p.error("--devices must be >= 1")
    if args.devices > 1:
        from repro_torch import device as device_lib
        from repro_torch.launch.mesh import run_ranks

        device_lib.resolve(args.device)
        ranks = run_ranks(_serve_rank, args.devices, (argv,),
                          device=args.device, timeout=3600.0)
        out = ranks[0]
        if any(r["outputs"] != out["outputs"] for r in ranks[1:]):
            raise RuntimeError("--devices: the ranks' streams differ")
    else:
        out = _serve(p, args)
    for line in out["lines"]:
        print(line)
    return out


def _serve_rank(argv: List[str]) -> Dict:
    """One rank of ``--devices N``: :func:`_serve` inside the rank's
    process group."""
    p = _parser()
    return _serve(p, p.parse_args(argv))


def _serve(p, args) -> Dict:
    lines: List[str] = []
    say = lines.append
    if args.policy:
        parts = args.policy.split("/")
        if len(parts) == 1:
            parts = parts * 3
        if len(parts) != 3:
            p.error("--policy takes one name or admission/preemption/eviction")
        args.admission, args.preemption, args.eviction = parts

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    serve = ServeConfig(model=args.arch, kv_block_size=args.block_size,
                        max_batch=args.requests, admission=args.admission,
                        preemption=args.preemption, eviction=args.eviction,
                        attn_impl=args.attn_impl, q_chunk=args.q_chunk,
                        prefetch_depth=args.prefetch_depth, spec=args.spec,
                        spec_k=args.spec_k, overlap=args.overlap == "on",
                        roles=args.roles, host_blocks=args.host_blocks,
                        trace=args.trace,
                        num_queries_per_block=args.num_queries_per_block,
                        num_kv_pages_per_block=args.num_kv_pages_per_block,
                        vmem_limit_bytes=args.vmem_limit_bytes,
                        sanitize=args.sanitize == "on",
                        devices=args.devices if args.devices > 1 else 0)
    trace, ctx = None, contextlib.nullcontext()
    if serve.trace:
        trace = Trace.load(serve.trace)
        total_blocks = sum(
            -(-(len(r.prompt) + r.max_new_tokens) // args.block_size) + 1
            for r in trace.requests)
        # policies resolve at engine construction: the context wraps it
        ctx = perf_context(scenario=trace.scenario,
                           length_model=LengthModel.fit(trace))
    else:
        total_blocks = args.requests * (
            -(-(args.prompt_len + args.max_new) // args.block_size) + 1)
    # roles: each engine gets the whole pool; on a host with two cards
    # the roles run on separate cards
    with ctx:
        if serve.roles:
            pair = None
            if (torch.device(args.device).type == "cuda"
                    and torch.cuda.device_count() >= 2):
                pair = ("cuda:0", "cuda:1")
            engine = DisaggEngine(model, params, cfg, serve,
                                  num_blocks=total_blocks, seed=args.seed,
                                  devices=pair, device=args.device)
        else:
            engine = ServingEngine(model, params, cfg, serve,
                                   num_blocks=total_blocks, seed=args.seed,
                                   device=args.device)
    t0 = time.time()
    if trace is not None:
        result = replay_lib.replay(engine, trace)
        report = replay_lib.score(result, replay_lib.Slo(
            ttft_s=args.slo_ttft, tpot_s=args.slo_tpot))
    else:
        rng = np.random.default_rng(args.seed)
        for i in range(args.requests):
            engine.submit(Request(
                req_id=i,
                prompt=rng.integers(0, cfg.vocab_size, (args.prompt_len,),
                                    dtype=np.int32),
                max_new_tokens=args.max_new))
        engine.run_until_done()
    dt = time.time() - t0
    m = engine.metrics()
    if trace is not None:
        c = result.counters()
        say(f"replayed trace {trace.name} [{trace.scenario}] "
            f"{len(trace.requests)} requests in {result.steps} virtual "
            f"steps ({c['idle_ff']} idle fast-forwards)")
        say(f"virtual TTFT p50 {report.p50_ttft_s:.2f} / p99 "
            f"{report.p99_ttft_s:.2f} s  TPOT p50 {report.p50_tpot_s:.3f} "
            f"/ p99 {report.p99_tpot_s:.3f} s  attainment "
            f"ttft={report.attainment_ttft:.0%} "
            f"tpot={report.attainment_tpot:.0%}  "
            f"SLO {'MET' if report.ok else 'MISSED'} "
            f"(targets {args.slo_ttft}s / {args.slo_tpot}s)")
    say(f"served {m['finished']} requests, {m['output_tokens']} tokens "
        f"in {dt:.2f}s ({m['output_tokens']/dt:.1f} tok/s) "
        f"[attention={m['backend']} device={args.device} "
        f"devices={m['devices']} mesh={m['mesh_shape']} "
        f"steps={m['steps']} overlap={m['overlap']}]")
    say(f"TTFT p50 {m['p50_ttft_s']*1e3:.1f} / p99 {m['p99_ttft_s']*1e3:.1f} "
        f"ms  TPOT p50 {m['p50_tpot_s']*1e3:.1f} / p99 "
        f"{m['p99_tpot_s']*1e3:.1f} ms")
    say(f"attn {m['attn_impl']}  q_chunk={m['q_chunk']} "
        f"prefetch_depth={m['prefetch_depth']} "
        f"num_queries_per_block={m['num_queries_per_block']} "
        f"num_kv_pages_per_block={m['num_kv_pages_per_block']} "
        f"vmem_limit_bytes={m['vmem_limit_bytes']}")
    say(f"preemptions {m['preemptions']}  "
        f"prefix hit rate {m['prefix_hit_rate']:.2f}  "
        f"cow copies {m['cow_copies']}")
    say(f"policies {m['admission_policy']}/{m['preemption_policy']}/"
        f"{m['eviction_policy']}  counters {m['policy_counters']}")
    t = m["tier"]
    say(f"role {m['role']}  tier hbm={t['hbm_blocks']} "
        f"host={t['host_blocks']} (used {t['host_blocks_used']})  "
        f"demotes {t['demotes']}  promotes {t['promotes']}  "
        f"hits {t['hits']}  drops {t['drops']}")
    if serve.roles:
        h = m["handoff_ms"]
        say(f"handoffs {m['handoffs']}  latency p50 {h['p50']:.2f} / "
            f"p99 {h['p99']:.2f} ms  prefill steps "
            f"{m['roles']['prefill']['steps']}  decode steps "
            f"{m['roles']['decode']['steps']}")
    san = m["sanitize"]
    say(f"sanitize {'on' if san['enabled'] else 'off'}  "
        f"retraces={san['retraces']} "
        f"transfer_guard_trips={san['transfer_guard_trips']} "
        f"invariant_checks={san['invariant_checks']} "
        f"allowed_host_syncs={san['allowed_host_syncs']} "
        f"compiles={san['compiles']}")
    s = m["spec"]
    say(f"spec {s['proposer']} k={s['k']}  "
        f"accept_rate {s['acceptance_rate']:.2f}  "
        f"mean_accepted {s['mean_accepted_len']:.2f}  "
        f"tokens/step {m['tokens_per_step']:.2f}")

    outputs = ({r.req_id: [int(t) for t in r.output] for r in
                engine.finished} if hasattr(engine, "finished") else {})
    return {"lines": lines, "outputs": outputs, "metrics": m}


if __name__ == "__main__":
    main()
