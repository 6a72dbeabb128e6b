"""Disaggregated prefill/decode serving and the host KV tier (port of the
reference's ``benchmarks/disagg.py``):

* ``llm_disagg_burst_*``: a burst of long prompts.  The monolithic engine
  carries prefill chunks in every fused step, so decode lanes inherit
  prefill-sized steps; the disaggregated frontend runs decode steps at a
  fixed decode:prefill cadence.  Same model, same pool per engine, the
  rows differ only in the role topology.
* ``llm_tier_pressure_*``: recurring prompts cycle through a pool smaller
  than their working set.  ``lru`` with no host tier drops evicted
  content, so only back-to-back reuse hits the prefix cache; ``tiered``
  with a host tier demotes evicted blocks that were reused and promotes
  them on the next recurrence: a higher prefix hit rate at the same pool.

Rows carry the reference's fields (``roles=``, ``tier=``, the handoff and
tier counters).  By default the reduced float32 smollm-360m with the
reference's weights (``bench/data``) at the reference's sizes; ``--smoke``
(or ``REPRO_BENCH_SMOKE`` set) the reference's smoke sizes, whose
counters equal the reference's; ``--full`` llama31-8b at full width (bf16,
seeded weights): 16 prompts of 1024 tokens, 32 new, max_batch 8, 512-token
prefill chunks, 16-token blocks, then the tier scenario at the
reference's sizes.

    python -m repro_torch.bench.disagg --full          # on the card
    PYTHONPATH=src python -m repro_torch.bench.disagg --device cpu --smoke
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.bench.common import emit
from repro_torch.config import ServeConfig
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Request, ServingEngine

# the reference's sizes: smoke, quick, and the paper's model at full width
SMOKE = dict(n_req=4, plen=40, max_new=8, max_batch=2, chunk=16, bs=8,
             n_prompts=3, rounds=2, tier_bs=8, hbm=7)
QUICK = dict(SMOKE, n_req=6, plen=96, max_new=16, n_prompts=5, rounds=3,
             hbm=11)
FULL = dict(QUICK, n_req=16, plen=1024, max_new=32, max_batch=8, chunk=512,
            bs=16)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drain(engine, device) -> float:
    """Run ``engine`` to the end; its wall seconds."""
    _sync(device)
    t0 = time.perf_counter()
    engine.run_until_done()
    _sync(device)
    return time.perf_counter() - t0


def prompts_of(vocab: int, sizes: Dict[str, int]):
    """The burst's prompts, then the tier scenario's, from one generator
    (as the reference draws them)."""
    rng = np.random.default_rng(0)
    burst = [rng.integers(0, vocab, (sizes["plen"],), dtype=np.int32)
             for _ in range(sizes["n_req"])]
    pressure = [rng.integers(0, vocab, (3 * sizes["tier_bs"],),
                             dtype=np.int32)
                for _ in range(sizes["n_prompts"])]
    return burst, pressure


def burst_blocks(sizes: Dict[str, int]) -> int:
    """Each engine's pool: every request's blocks and one more."""
    return sizes["n_req"] * (
        -(-(sizes["plen"] + sizes["max_new"]) // sizes["bs"]) + 1)


def burst_engine(model, params, cfg, sizes, roles: str, device, **kw):
    """The monolithic (``roles=""``) or split engine of the burst, with its
    requests submitted."""
    serve = ServeConfig(model=cfg.name, kv_block_size=sizes["bs"],
                        max_batch=sizes["max_batch"],
                        prefill_chunk=sizes["chunk"], roles=roles)
    blocks = burst_blocks(sizes)
    if roles:
        eng = DisaggEngine(model, params, cfg, serve, num_blocks=blocks,
                           device=device, **kw)
    else:
        eng = ServingEngine(model, params, cfg, serve, num_blocks=blocks,
                            device=device, **kw)
    burst, _ = prompts_of(cfg.vocab_size, sizes)
    for i, p in enumerate(burst):
        eng.submit(Request(req_id=i, prompt=p,
                           max_new_tokens=sizes["max_new"]))
    return eng


def pressure_engine(model, params, cfg, sizes, eviction: str,
                    host_blocks: int, device):
    serve = ServeConfig(model=cfg.name, kv_block_size=sizes["tier_bs"],
                        max_batch=1, eviction=eviction,
                        host_blocks=host_blocks)
    return ServingEngine(model, params, cfg, serve, num_blocks=sizes["hbm"],
                         device=device)


def pressure_run(eng, cfg, sizes, device) -> float:
    """Each prompt twice back to back (the reuse that earns hits), every
    round; the wall seconds."""
    _, prompts = prompts_of(cfg.vocab_size, sizes)
    _sync(device)
    t0 = time.perf_counter()
    rid = 0
    for _ in range(sizes["rounds"]):
        for p in prompts:
            for _ in range(2):
                eng.submit(Request(req_id=rid, prompt=p, max_new_tokens=6))
                rid += 1
            eng.run_until_done()
    _sync(device)
    return time.perf_counter() - t0


def _tier_str(m) -> str:
    t = m["tier"]
    return f"tier=hbm:{t['hbm_blocks']}+host:{t['host_blocks']}"


def burst_row(tag: str, engine, dt: float, roles: str):
    m = engine.metrics()
    extra = ""
    if roles != "full":
        h = m["handoff_ms"]
        extra = (f";handoffs={m['handoffs']};"
                 f"handoff_p50_ms={h['p50']:.2f};"
                 f"prefill_steps={m['roles']['prefill']['steps']};"
                 f"decode_steps={m['roles']['decode']['steps']}")
    return emit(tag, dt * 1e3,
                f"tpot_p50_ms={m['p50_tpot_s']*1e3:.1f};"
                f"tpot_p99_ms={m['p99_tpot_s']*1e3:.1f};"
                f"ttft_p50_ms={m['p50_ttft_s']*1e3:.1f};"
                f"ttft_p99_ms={m['p99_ttft_s']*1e3:.1f};"
                f"tok_s={m['throughput_tok_s']:.1f};"
                f"finished={m['finished']};"
                f"backend={m['backend']};"
                f"roles={roles.replace(',', '+')};{_tier_str(m)}" + extra)


def pressure_row(tag: str, eng, dt: float):
    m = eng.metrics()
    t = m["tier"]
    return emit(tag, dt * 1e3,
                f"prefix_hit_rate={m['prefix_hit_rate']:.2f};"
                f"prefix_hits={m['prefix_hits']};"
                f"evictions={eng.alloc.cache_evictions};"
                f"demotes={t['demotes']};promotes={t['promotes']};"
                f"tier_hits={t['hits']};drops={t['drops']};"
                f"finished={m['finished']};"
                f"eviction={m['eviction_policy']};"
                f"roles=full;{_tier_str(m)}")


def run(model, params, cfg, *, device="cuda",
        sizes: Dict[str, int] = QUICK) -> List[Dict[str, object]]:
    """The four rows: burst mono and split, tier pressure lru and tiered."""
    n, rounds = sizes["n_req"], sizes["rounds"]
    rows = []
    mono = burst_engine(model, params, cfg, sizes, "", device)
    rows.append(burst_row(f"llm_disagg_burst_mono_n{n}", mono,
                          drain(mono, device), "full"))
    del mono
    split = burst_engine(model, params, cfg, sizes, "prefill,decode", device)
    rows.append(burst_row(f"llm_disagg_burst_split_n{n}", split,
                          drain(split, device), "prefill,decode"))
    del split
    for tag, eviction, host in (("hbm_only", "lru", 0),
                                ("tiered", "tiered", 4 * sizes["n_prompts"])):
        eng = pressure_engine(model, params, cfg, sizes, eviction, host,
                              device)
        dt = pressure_run(eng, cfg, sizes, device)
        rows.append(pressure_row(f"llm_tier_pressure_{tag}_r{rounds}", eng,
                                 dt))
    return rows


def main(argv=None) -> int:
    from repro_torch.bench.trace_replay import build

    p = argparse.ArgumentParser(prog="python -m repro_torch.bench.disagg")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    p.add_argument("--full", action="store_true",
                   help="llama31-8b at full width (bf16, seeded weights)")
    p.add_argument("--smoke", action="store_true",
                   help="the reference's smoke sizes (also set by "
                        "REPRO_BENCH_SMOKE)")
    args = p.parse_args(argv)
    if args.full:
        cfg, model, params = build("llama31-8b", False, args.device)
        sizes = FULL
    else:
        cfg, model, params = build("smollm-360m", True, args.device)
        smoke = args.smoke or bool(os.environ.get("REPRO_BENCH_SMOKE"))
        sizes = SMOKE if smoke else QUICK
    run(model, params, cfg, device=args.device, sizes=sizes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
