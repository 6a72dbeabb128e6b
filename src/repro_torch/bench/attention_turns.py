"""Two or more source trees of the port on one card, in turns: their
ragged, chunked and decode paged-attention kernels on the same inputs
(captured layer-0 inputs of a serving step, and seeded decode batches),
and their serving engines on the same workload.

    PYTHONPATH=src python -m repro_torch.bench.attention_turns \
        --trees OLD NEW [--order 0110] [--out DIR]

``OLD`` and ``NEW`` are roots of checkouts of the repo (for example a
parent commit unpacked with ``git archive`` into a git-ignored directory,
and this tree); more trees may follow, say copies of one tree that differ
in one constant, each named in ``--order`` by its index.  The workload is
``chip_smoke.py`` phase 5's: full-width smollm-360m (bf16, seeded random
weights), 16 requests of 128-1024 prompt tokens (every fourth longer than
512 opens with a shared 256-token prefix), 32 new tokens each, 16-token
blocks, a 4096-block pool.

First a process of the last tree serves the workload once through the
ragged kernel and saves layer 0's inputs of the first mixed step and the
first decode-only step to ``DIR``.  Then each turn (``--order``: indices
into ``--trees``, default parent, change, change, parent) is a process
that imports ``repro_torch`` from that tree's ``src`` (its kernels build
into that tree's ``build/``; the runner is :mod:`repro_torch.bench.turns`)
and prints one JSON line:

* ``kernels``: the ragged kernel on the saved inputs, and the chunked
  kernel on the same lanes (``q_chunk`` 16, the engine's default), in ms
  (CUDA events over back-to-back launches through the C entry point);
  for the mixed step also the ragged kernel on its prefill sequences
  alone and on its decode lanes alone (``mixed_prefill``,
  ``mixed_decode``);
* ``decode_kernel``: the decode kernel (B3) in ms, the same way, on
  seeded batches (:data:`DECODE_BATCHES`): the paper path's last step at
  smollm-360m's widths in bf16, long-context requests of 1 to 3999 keys,
  and Fig 17's widths in float32 at 32 and 128 requests of 1024 keys;
* ``serve``: TTFT and TPOT p50/p99 of the workload through each kernel;
* ``mixed_profile``: torch.profiler over the first mixed step of each:
  wall, device busy share, the attention kernel's device ms.

Every number comes from the card; without one the script exits nonzero.
The script imports only what both trees have, so it can time an older one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

SERVE_BLOCKS, SERVE_BS, SERVE_BATCH, SERVE_NEW = 4096, 16, 16, 32
SMOLLM = dict(num_heads=15, num_kv=5, head_dim=64, block_size=16)
FIG17 = dict(num_heads=32, num_kv=8, head_dim=128, block_size=16)
# name: (widths, dtype, seq_lens): chip_smoke.py phase 16's last step (16
# requests of 128 + 32 - 1 keys), long-context requests, Fig 17's widths
DECODE_BATCHES = {
    "paper_last_step": (SMOLLM, "bfloat16", [159] * 16),
    "long_context": (SMOLLM, "bfloat16", [1, 256, 257, 700, 129, 0, 3999]),
    "fig17_B32_S1024": (FIG17, "float32", [1024] * 32),
    "fig17_B128_S1024": (FIG17, "float32", [1024] * 128),
}


def workload(cfg, engine_mod, np):
    """chip_smoke.py phase 5's requests (its warm-up draws first)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, (256,), dtype=np.int32)

    def requests(n, lo, hi, new):
        out = []
        for i in range(n):
            length = int(rng.integers(lo, hi))
            p = rng.integers(0, cfg.vocab_size, (length,), dtype=np.int32)
            if i % 4 == 0 and length > 2 * len(shared):
                p[:len(shared)] = shared
            out.append((i, p, new))
        return out

    warm = requests(2, 64, 65, 4)
    return warm, requests(16, 128, 1025, SERVE_NEW)


def _model(torch, np):
    from repro_torch import config as cfg_mod
    from repro_torch.models.api import build_model
    from repro_torch.serving import engine as engine_mod

    cfg = cfg_mod.get_config("smollm-360m")
    model = build_model(cfg, device=torch.device("cuda"))
    params = model.init(seed=0)
    return cfg_mod, engine_mod, cfg, model, params


def _engine(cfg_mod, engine_mod, cfg, model, params, attn_impl, blocks):
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                max_batch=SERVE_BATCH, attn_impl=attn_impl)
    return engine_mod.ServingEngine(model, params, cfg, serve,
                                    num_blocks=blocks, device="cuda")


def _submit(engine_mod, eng, reqs):
    for i, p, new in reqs:
        eng.submit(engine_mod.Request(req_id=i, prompt=p,
                                      max_new_tokens=new))


def _kind(plan):
    return ("mixed" if plan.decode and plan.prefill else
            "decode" if plan.decode else "prefill")


def capture(out_dir: str) -> None:
    """Serve the workload through the ragged kernel and save layer 0's
    inputs of its first mixed and first decode-only step."""
    import numpy as np
    import torch
    from repro_torch.core import attention_api as api

    cfg_mod, engine_mod, cfg, model, params = _model(torch, np)
    warm, reqs = workload(cfg, engine_mod, np)
    eng = _engine(cfg_mod, engine_mod, cfg, model, params, "ragged",
                  SERVE_BLOCKS)
    got, state = {}, {"want": None}
    render, op = eng._render, api.paged_attention_ragged_op

    def spy_render(plan):
        kind = _kind(plan)
        state["want"] = kind if kind != "prefill" and kind not in got \
            else None
        return render(plan)

    def spy_op(*args, **kw):
        out = op(*args, **kw)
        if state["want"] is not None:
            got[state["want"]] = [a.cpu() for a in args]
            state["want"] = None
        return out

    eng._render = spy_render
    api.paged_attention_ragged_op = spy_op
    _submit(engine_mod, eng, reqs)
    eng.run_until_done()
    api.paged_attention_ragged_op = op
    torch.save(got, Path(out_dir) / "inputs.pt")
    print(json.dumps({"captured": sorted(got), "prompts": sorted(
        len(p) for _, p, _ in reqs)}), flush=True)


def _profile_first_mixed(torch, engine_mod, eng, reqs):
    """torch.profiler over the engine's first mixed step."""
    from torch.profiler import ProfilerActivity, profile

    kinds = []
    render = eng._render

    def spy(plan):
        kinds.append(_kind(plan))
        return render(plan)

    eng._render = spy
    _submit(engine_mod, eng, reqs)
    while not any(r.state.name == "DECODING" for r in eng.active.values()):
        eng.step()
    before = len(kinds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if kinds[before:] != ["mixed"]:
        raise AssertionError(f"profiled {kinds[before:]}, not a mixed step")
    busy = attn = 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        busy += us
        if "attention_kernel" in e.key:
            attn += us
    if busy <= 0:
        raise AssertionError("the profiler saw no device activity")
    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3,
                busy_share=busy / 1e3 / wall_ms, attention_ms=attn / 1e3)


def select_sequences(args, keep):
    """The ragged call ``args`` cut to the lanes of the sequences ``j``
    with ``keep(nq_j)``; the others stay as empty entries (no lanes, the
    same slot and keys), so the slots, the pool and the BlockList are as
    they were."""
    import torch

    q, pool, bl, br, bp, cu_q, cu_kv, ss = args
    cq = cu_q.tolist()
    nq = [cq[j + 1] - cq[j] if keep(cq[j + 1] - cq[j]) else 0
          for j in range(len(ss))]
    lanes = [t for j in range(len(ss)) if nq[j]
             for t in range(cq[j], cq[j + 1])]
    new_cq = torch.tensor([0] + nq, dtype=torch.int32,
                          device=q.device).cumsum(0, dtype=torch.int32)
    return [q[torch.tensor(lanes, device=q.device).long()].contiguous(),
            pool, bl, br, bp, new_cq, cu_kv, ss]


def measure(out_dir: str) -> None:
    """One turn: kernel times on the saved inputs, then the workload
    through each kernel, then a profile of each one's first mixed step."""
    import numpy as np
    import torch
    from repro_torch.bench.common import kernel_ms
    from repro_torch.core import attention_api as api
    from repro_torch.core.paged_kv import fused_kv_views
    from repro_torch.kernels.paged_attention.cases import (
        DECODE_ARG_ORDER, decode_case)

    dev = torch.device("cuda")
    saved = torch.load(Path(out_dir) / "inputs.pt")
    kernels = {}
    for kind, args in sorted(saved.items()):
        args = [a.to(dev) for a in args]
        q, pool, bl, br, bp, cu_q, cu_kv, ss = args
        treq, tpos, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss,
                                                   q.shape[0], ss.shape[0])
        cargs = [q, *fused_kv_views(pool), bl, br, bp, kvl, treq, tpos]
        ragged = api.paged_attention_ragged_op(*args)
        chunked = api.paged_attention_chunked_op(*cargs)
        torch.cuda.synchronize()
        kernels[kind] = dict(
            ragged_ms=kernel_ms(api.paged_attention_ragged_op, *args,
                                device=dev, reps=50),
            chunked_ms=kernel_ms(api.paged_attention_chunked_op, *cargs,
                                 device=dev, reps=50),
            chunked_equals_ragged=bool(torch.equal(ragged, chunked)),
            real_lanes=int(cu_q[-1]), lanes=int(q.shape[0]))
        if kind == "mixed":
            for part, keep in (("prefill", lambda n: n >= 2),
                               ("decode", lambda n: n == 1)):
                sub = select_sequences(args, keep)
                kernels[f"mixed_{part}"] = dict(
                    ragged_ms=kernel_ms(api.paged_attention_ragged_op, *sub,
                                        device=dev, reps=50),
                    real_lanes=int(sub[0].shape[0]))
    decode = {}
    for name, (widths, dtype, lens) in DECODE_BATCHES.items():
        pages = sum(-(-n // widths["block_size"]) for n in lens)
        c = decode_case(np.random.default_rng(0), **widths,
                        num_blocks=pages + 8, seq_lens=lens,
                        num_entries=pages)
        args = [torch.from_numpy(c[k]).to(dev) for k in DECODE_ARG_ORDER]
        args[:3] = [a.to(getattr(torch, dtype)) for a in args[:3]]
        decode[name] = kernel_ms(api.paged_attention_op, *args, device=dev,
                                 reps=50)
    cfg_mod, engine_mod, cfg, model, params = _model(torch, np)
    warm, reqs = workload(cfg, engine_mod, np)
    serve, profiles, streams = {}, {}, {}
    for attn_impl in ("ragged", "chunked"):
        eng = _engine(cfg_mod, engine_mod, cfg, model, params, attn_impl,
                      256)
        _submit(engine_mod, eng, [(i, p[:64], 4) for i, p, _ in reqs[:2]])
        eng.run_until_done()
        eng = _engine(cfg_mod, engine_mod, cfg, model, params, attn_impl,
                      SERVE_BLOCKS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _submit(engine_mod, eng, reqs)
        eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = eng.metrics()
        streams[attn_impl] = {r.req_id: list(r.output) for r in eng.finished}
        serve[attn_impl] = dict(
            wall_s=wall, steps=m["steps"],
            ttft_p50_ms=m["p50_ttft_s"] * 1e3,
            ttft_p99_ms=m["p99_ttft_s"] * 1e3,
            tpot_p50_ms=m["p50_tpot_s"] * 1e3,
            tpot_p99_ms=m["p99_tpot_s"] * 1e3)
        eng = _engine(cfg_mod, engine_mod, cfg, model, params, attn_impl,
                      SERVE_BLOCKS)
        profiles[attn_impl] = _profile_first_mixed(torch, engine_mod, eng,
                                                   reqs)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "kernels": kernels,
        "decode_kernel": decode, "serve": serve, "mixed_profile": profiles,
        "streams_equal": streams["ragged"] == streams["chunked"]}),
        flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--order", default="0110")
    ap.add_argument("--out", default="build/turns")
    ap.add_argument("--worker", choices=("capture", "measure"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_turns: no CUDA card")
    if args.worker:
        (capture if args.worker == "capture" else measure)(args.out)
        return 0
    from repro_torch.bench import turns

    os.makedirs(args.out, exist_ok=True)
    script = str(Path(__file__).resolve())
    last = Path(args.trees[-1]).resolve()
    print(json.dumps(turns.in_tree(script, last, [
        "--worker", "capture", "--trees", str(last), "--out", args.out])),
        flush=True)
    turns.run(script, args.trees, args.order, lambda turn, tree: [
        "--worker", "measure", "--trees", str(tree), "--out", args.out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
