"""End-to-end LLM serving with the port's scheduler-driven stack (port of
the reference's ``examples/serve_llm.py``): chunked prefill fused into the
decode step, prefix-cached paged KV, per-request sampling and preemption
under block pressure, with a non-default policy triple (priority
admission, fewest-remaining-tokens preemption, hit-rate eviction).

``--arch`` picks the config (the reference's reduced float32 qwen2-1.5b by
default; any dense or MoE config of the port), ``--full`` serves it at its
full width in its own dtype (on a card: granite-moe-1b-a400m fits one,
qwen3-moe-235b-a22b does not).

    python -m repro_torch.examples.serve_llm                # on the card
    PYTHONPATH=src python -m repro_torch.examples.serve_llm --device cpu
    python -m repro_torch.examples.serve_llm --arch granite-moe-1b-a400m --full
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, SamplingParams, ServingEngine


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--arch", default="qwen2-1.5b")
    p.add_argument("--full", action="store_true",
                   help="the config at full width (default: reduced, "
                        "float32)")
    args = p.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    serve = ServeConfig(model=cfg.name, kv_block_size=8, max_batch=4,
                        admission="priority",
                        preemption="fewest-remaining-tokens",
                        eviction="hit-rate")
    engine = ServingEngine(model, params, cfg, serve, num_blocks=128,
                           device=args.device)

    rng = np.random.default_rng(0)
    # a shared "system prompt" (prefix-cache hits after the first wave),
    # tails of varied length, greedy and stochastic sampling, and late
    # high-priority requests that the admission policy moves up the queue
    system_prompt = rng.integers(0, cfg.vocab_size, (16,), dtype=np.int32)
    for i in range(8):
        tail = rng.integers(0, cfg.vocab_size,
                            (int(rng.integers(2, 8)),), dtype=np.int32)
        sampling = (SamplingParams() if i % 2 == 0 else
                    SamplingParams(temperature=0.8, top_k=40, top_p=0.95))
        engine.submit(Request(
            req_id=i,
            prompt=np.concatenate([system_prompt, tail]),
            max_new_tokens=int(rng.integers(4, 10)),
            priority=1 if i >= 6 else 0,
            sampling=sampling))
    t0 = time.time()
    engine.run_until_done()
    dt = time.time() - t0
    m = engine.metrics()
    print(f"served {m['finished']} requests / {m['output_tokens']} tokens "
          f"in {dt:.1f}s ({m['throughput_tok_s']:.1f} tok/s)")
    print(f"TTFT p50/p99 {m['p50_ttft_s']*1e3:.0f}/{m['p99_ttft_s']*1e3:.0f} "
          f"ms, TPOT p50/p99 {m['p50_tpot_s']*1e3:.0f}/"
          f"{m['p99_tpot_s']*1e3:.0f} ms")
    print(f"prefix hit rate {m['prefix_hit_rate']:.2f} "
          f"({m['prefix_hits']} hits), preemptions {m['preemptions']}, "
          f"CoW copies {m['cow_copies']}")
    print(f"policies {m['admission_policy']}/{m['preemption_policy']}/"
          f"{m['eviction_policy']}  counters {m['policy_counters']}")
    print(f"pool leak check: {m['blocks_free']} == 128")
    assert m["blocks_free"] == 128
    assert m["prefix_hits"] > 0
    assert m["admission_policy"] == "priority"
    assert m["policy_counters"]["admission.admitted"] == 8


if __name__ == "__main__":
    main()
