"""Paper Fig 12 + 17 d/e: end-to-end LLM serving (port of the reference's
``benchmarks/llm_e2e.py``): the prefill / decode latency breakdown across
output lengths, then scenario sweeps through the scheduler-driven engine
(chunked prefill, prefix-cached paged KV, preemption):

* ``llm_breakdown_out*``: one ``forward(last_only=True)`` over B prompts
  against one contiguous-cache ``decode_step``, as shares of a request of
  25 / 100 / 400 output tokens;
* ``llm_engine_*``: continuous batching over variable lengths, p50/p99
  TTFT/TPOT and tokens/s;
* ``llm_burst_*``: the whole wave lands at t0 and queues behind max_batch;
* ``llm_prefix_*``: a shared system prompt, the prefix cache's hit rate
  and fresh blocks against independent prompts;
* ``llm_preempt_*``: a pool below the working set forces preemption;
* ``llm_repeat_*``: looping prompt motifs, where the ``ngram`` proposer's
  drafts land (acceptance rate, output tokens per decode lane).

Every engine row carries the resolved policy triple and proposer, so
``bench.run --policy`` / ``--spec`` sweeps attribute each scenario.  The
requests are drawn from one ``np.random.default_rng(0)`` in the reference's
order, so the counters equal the reference's on its model and weights.
``REPRO_BENCH_SMOKE=1`` runs only the four scenario sweeps at their
smallest sizes and skips the ``draft-model`` proposer, as the reference.
Times are milliseconds (``bench.common.emit``); the engine rows' ``backend``
is the port's (``cuda`` or ``plain``).

By default the reference's model: reduced float32 smollm-360m with the
reference's weights (``bench.trace_replay.REFERENCE_WEIGHTS``); a caller
may pass any config and parameters (``chip_smoke.py`` serves llama31-8b at
full width with seeded weights).  Multi-card serving
(``REPRO_BENCH_DEVICES`` > 1) waits for the port's mesh and is refused.

    PYTHONPATH=src REPRO_BENCH_SMOKE=1 python -m repro_torch.bench.run \\
        --device cpu --only llm_e2e
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import emit, time_ms
from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.engine import Request, ServingEngine

# the derived fields that are times (or ratios of times): everything else
# in a row, but ``backend``, is a counter that equals across devices
TIMED = ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
         "tok_s", "speedup_vs_indep", "prefill_frac", "decode_frac")
MULTI_CARD = ("multi-card serving (the reference's serving mesh) waits "
              "for the port's multi-card support")


def smoke() -> bool:
    return bool(os.environ.get("REPRO_BENCH_SMOKE"))


def refuse_mesh() -> None:
    """Raise where ``REPRO_BENCH_DEVICES`` asks for more than one card."""
    want = int(os.environ.get("REPRO_BENCH_DEVICES", "0") or 0)
    if want > 1:
        raise ValueError(f"REPRO_BENCH_DEVICES={want}: {MULTI_CARD}")


def counters(row: Dict[str, object]) -> Dict[str, str]:
    """A row's derived fields that are not times, nor ``backend``."""
    out = {}
    for item in str(row["derived"]).split(";"):
        key, _, val = item.partition("=")
        if key not in TIMED and key != "backend":
            out[key] = val
    return out


def reference_model(device):
    """(cfg, model, params): the reference's reduced float32 smollm-360m
    with its own weights."""
    from repro_torch.bench.trace_replay import REFERENCE_WEIGHTS, load_weights

    cfg = get_config("smollm-360m").reduced(dtype="float32")
    return (cfg, build_model(cfg, device=device, remat=False),
            load_weights(REFERENCE_WEIGHTS, device))


def drain(engine) -> float:
    """Seconds to run ``engine`` until it is done (it reads its sampled
    tokens on the host, so the card is done too)."""
    t0 = time.perf_counter()
    engine.run_until_done()
    return time.perf_counter() - t0


def emit_engine(tag: str, engine, dt: float) -> Dict[str, object]:
    m = engine.metrics()
    s = m["spec"]
    return emit(tag, dt * 1e3,
                f"ttft_p50_ms={m['p50_ttft_s']*1e3:.1f};"
                f"ttft_p99_ms={m['p99_ttft_s']*1e3:.1f};"
                f"tpot_p50_ms={m['p50_tpot_s']*1e3:.1f};"
                f"tpot_p99_ms={m['p99_tpot_s']*1e3:.1f};"
                f"tok_s={m['throughput_tok_s']:.1f};"
                f"preempt={m['preemptions']};"
                f"finished={m['finished']};"
                f"prefix_hit_rate={m['prefix_hit_rate']:.2f};"
                f"backend={m['backend']};"
                f"devices={m['devices']};"
                f"policies={m['admission_policy']}/{m['preemption_policy']}/"
                f"{m['eviction_policy']};"
                f"spec={s['proposer']};"
                f"spec_accept={s['acceptance_rate']:.2f};"
                f"tok_per_lane={s['tokens_per_decode_lane']:.2f}")


def breakdown(model, params, cfg, dev, quick: bool) -> List[Dict[str, object]]:
    """Fig 12b: prefill (``forward(last_only=True)``) against one
    ``decode_step`` on an ``init_decode_cache`` of in_len + 64."""
    B, in_len = (2, 64) if quick else (16, 100)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, in_len), dtype=np.int32)).to(dev)
    with torch.no_grad():
        ms_prefill = time_ms(
            lambda p, t: model.forward(p, t, last_only=True)[0], params,
            toks, device=dev, reps=3)
        cache = model.init_decode_cache(B, in_len + 64)
        one = torch.zeros((B,), dtype=torch.int32, device=dev)
        ms_decode = time_ms(lambda p, c, t: model.decode_step(p, c, t)[0],
                            params, cache, one, device=dev, reps=3)
    rows = []
    for out_len in (25, 100, 400):
        total = ms_prefill + out_len * ms_decode
        rows.append(emit(f"llm_breakdown_out{out_len}", total,
                         f"prefill_frac={ms_prefill / total:.2f};"
                         f"decode_frac={out_len * ms_decode / total:.2f}"))
    return rows


def run(device="cuda", quick: bool = True, cfg=None,
        params=None) -> List[Dict[str, object]]:
    """The module's rows (``name``, ``ms``, ``derived``).  ``cfg`` and
    ``params`` default to the reference's model and weights."""
    refuse_mesh()
    dev = device_lib.resolve(device)
    is_smoke = smoke()
    if is_smoke and spec_lib.forced_proposer() == "draft-model":
        return []   # k draft forwards a decode step: the smoke is off/ngram
    if cfg is None:
        cfg, model, params = reference_model(dev)
    else:
        model = build_model(cfg, device=dev, remat=False)
    rows: List[Dict[str, object]] = []

    def engine(serve, num_blocks):
        return ServingEngine(model, params, cfg, serve,
                             num_blocks=num_blocks, device=dev)

    if not is_smoke:
        rows += breakdown(model, params, cfg, dev, quick)

    rng = np.random.default_rng(0)

    def var_requests(n):
        return [Request(
            req_id=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(4, 12)),), dtype=np.int32),
            max_new_tokens=int(rng.integers(3, 8))) for i in range(n)]

    if not is_smoke:
        # continuous batching TTFT/TPOT with variable lengths (Fig 17 d/e)
        n_req = 3 if quick else 16
        for max_batch in ([2] if quick else [2, 8, 32]):
            eng = engine(ServeConfig(model=cfg.name, kv_block_size=8,
                                     max_batch=max_batch), 256)
            for r in var_requests(n_req):
                eng.submit(r)
            rows.append(emit_engine(f"llm_engine_maxbatch{max_batch}", eng,
                                    drain(eng)))

    # bursty arrivals: the whole wave lands at t0 and queues behind max_batch
    n_burst = 3 if is_smoke else (6 if quick else 32)
    serve = ServeConfig(model=cfg.name, kv_block_size=8, max_batch=2)
    eng = engine(serve, 256)
    for r in var_requests(n_burst):
        eng.submit(r)
    rows.append(emit_engine(f"llm_burst_n{n_burst}", eng, drain(eng)))

    # shared-prefix workload: common system prompt, prefix cache reuses blocks
    n_pfx = 3 if is_smoke else (6 if quick else 24)
    plen = 16
    prefix = rng.integers(0, cfg.vocab_size, (plen,), dtype=np.int32)
    eng_shared = engine(serve, 256)
    for i in range(n_pfx):
        tail = rng.integers(0, cfg.vocab_size, (4,), dtype=np.int32)
        eng_shared.submit(Request(req_id=i,
                                  prompt=np.concatenate([prefix, tail]),
                                  max_new_tokens=4))
    dt = drain(eng_shared)
    eng_indep = engine(serve, 256)
    for i in range(n_pfx):
        eng_indep.submit(Request(
            req_id=i,
            prompt=rng.integers(0, cfg.vocab_size, (plen + 4,),
                                dtype=np.int32),
            max_new_tokens=4))
    dt_i = drain(eng_indep)
    m = eng_shared.metrics()
    rows.append(emit(
        f"llm_prefix_shared_n{n_pfx}", dt * 1e3,
        f"prefix_hit_rate={m['prefix_hit_rate']:.2f};"
        f"blocks_allocated={eng_shared.alloc.blocks_allocated};"
        f"indep_blocks_allocated={eng_indep.alloc.blocks_allocated};"
        f"speedup_vs_indep={dt_i/max(dt, 1e-9):.2f}"))
    del eng_shared, eng_indep

    # memory pressure: pool below the working set forces preemption
    eng = engine(ServeConfig(model=cfg.name, kv_block_size=4, max_batch=3),
                 10)
    for i in range(3):
        eng.submit(Request(
            req_id=i,
            prompt=rng.integers(0, cfg.vocab_size, (6,), dtype=np.int32),
            max_new_tokens=8))
    dt = drain(eng)
    m = eng.metrics()
    rows.append(emit(
        "llm_preempt_pressure", dt * 1e3,
        f"preemptions={m['preemptions']};finished={m['finished']};"
        f"tok_s={m['throughput_tok_s']:.1f};"
        f"policies={m['admission_policy']}/{m['preemption_policy']}/"
        f"{m['eviction_policy']}"))

    # repetitive-suffix workload: prompts loop a short motif and greedy
    # decodes fall into loops of their own, which the ngram proposer reads
    n_rep = 3 if is_smoke else (6 if quick else 16)
    eng = engine(serve, 256)
    for i in range(n_rep):
        motif = rng.integers(0, cfg.vocab_size, (3,), dtype=np.int32)
        eng.submit(Request(req_id=i, prompt=np.tile(motif, 4),
                           max_new_tokens=16))
    rows.append(emit_engine(f"llm_repeat_n{n_rep}", eng, drain(eng)))
    return rows
