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
``predicted-length`` learns from the trace.

Weights are random, drawn from a seeded generator on the device.  Pass
``--device cpu`` (with ``--reduced`` for a tiny float32 model) to run the
plain PyTorch path without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.perf import replay as replay_lib
from repro_torch.perf.table import perf_context
from repro_torch.perf.trace import LengthModel, Trace
from repro_torch.serving import policy as policy_lib
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> None:
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
    for axis in policy_lib.AXES:
        p.add_argument(f"--{axis}", default=policy_lib.DEFAULTS[axis],
                       choices=policy_lib.names(axis),
                       help=f"serving {axis} policy")
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
    args = p.parse_args(argv)

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
                        trace=args.trace)
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
    with ctx:
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
        print(f"replayed trace {trace.name} [{trace.scenario}] "
              f"{len(trace.requests)} requests in {result.steps} virtual "
              f"steps ({c['idle_ff']} idle fast-forwards)")
        print(f"virtual TTFT p50 {report.p50_ttft_s:.2f} / p99 "
              f"{report.p99_ttft_s:.2f} s  TPOT p50 {report.p50_tpot_s:.3f} "
              f"/ p99 {report.p99_tpot_s:.3f} s  attainment "
              f"ttft={report.attainment_ttft:.0%} "
              f"tpot={report.attainment_tpot:.0%}  "
              f"SLO {'MET' if report.ok else 'MISSED'} "
              f"(targets {args.slo_ttft}s / {args.slo_tpot}s)")
    print(f"served {m['finished']} requests, {m['output_tokens']} tokens "
          f"in {dt:.2f}s ({m['output_tokens']/dt:.1f} tok/s) "
          f"[attention={m['backend']} device={engine.device} "
          f"steps={m['steps']} overlap={m['overlap']}]")
    print(f"TTFT p50 {m['p50_ttft_s']*1e3:.1f} / p99 {m['p99_ttft_s']*1e3:.1f} "
          f"ms  TPOT p50 {m['p50_tpot_s']*1e3:.1f} / p99 "
          f"{m['p99_tpot_s']*1e3:.1f} ms")
    print(f"attn {m['attn_impl']}  q_chunk={m['q_chunk']} "
          f"prefetch_depth={m['prefetch_depth']}")
    print(f"preemptions {m['preemptions']}  "
          f"prefix hit rate {m['prefix_hit_rate']:.2f}  "
          f"cow copies {m['cow_copies']}")
    print(f"policies {m['admission_policy']}/{m['preemption_policy']}/"
          f"{m['eviction_policy']}  counters {m['policy_counters']}")
    s = m["spec"]
    print(f"spec {s['proposer']} k={s['k']}  "
          f"accept_rate {s['acceptance_rate']:.2f}  "
          f"mean_accepted {s['mean_accepted_len']:.2f}  "
          f"tokens/step {m['tokens_per_step']:.2f}")


if __name__ == "__main__":
    main()
