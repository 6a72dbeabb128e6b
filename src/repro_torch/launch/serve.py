"""Serving launcher of the port: continuous batching over the paged KV
cache, attention through a hand-written CUDA kernel on a card (``--attn-impl
ragged`` or ``chunked``) —
``python -m repro_torch.launch.serve --arch smollm-360m --requests 8``.

Weights are random, drawn from a seeded generator on the device.  Pass
``--device cpu`` (with ``--reduced`` for a tiny float32 model) to run the
plain PyTorch path without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.serving import policy as policy_lib
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
                        prefetch_depth=args.prefetch_depth)
    total_blocks = args.requests * (
        -(-(args.prompt_len + args.max_new) // args.block_size) + 1)
    engine = ServingEngine(model, params, cfg, serve, num_blocks=total_blocks,
                           seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i in range(args.requests):
        engine.submit(Request(
            req_id=i,
            prompt=rng.integers(0, cfg.vocab_size, (args.prompt_len,),
                                dtype=np.int32),
            max_new_tokens=args.max_new))
    engine.run_until_done()
    dt = time.time() - t0
    m = engine.metrics()
    print(f"served {m['finished']} requests, {m['output_tokens']} tokens "
          f"in {dt:.2f}s ({m['output_tokens']/dt:.1f} tok/s) "
          f"[attention={m['backend']} device={engine.device} "
          f"steps={m['steps']}]")
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


if __name__ == "__main__":
    main()
