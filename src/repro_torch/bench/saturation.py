"""Saturation profile of the overlapped engine loop, and the chunked
kernel's (B2) depth x page sweep (port of the reference's
``benchmarks/saturation.py``):

* ``llm_saturation_overlap_{off,on}``: offered load far past capacity (a
  whole wave at t0 against a small batch and a tight pool), so the engine
  is never idle.  Run with overlap off (build, then resolve) and on (build
  step n+1 while step n runs); ``device_frac`` is the device phase's share
  of the phases' wall.  With ``REPRO_SANITIZE=1`` the wave runs under the
  runtime sanitizers (``ServeConfig.sanitize``) and the module asserts
  zero retraces, zero host-sync trips and some allocator checks.
* ``paged_dma_profile_bs*_d*``: B2 (``attention_api.
  paged_attention_chunked_op``) over prefetch depth x page size at a fixed
  total of keys, with the reference's keys (``depth``, ``page``,
  ``kv_pages``, the bytes and FLOPs a page step must move and compute).
  The TPU kernel's depth chose a ring of page DMAs; the CUDA kernel stages
  each 64-key stage through shared memory and ignores the depth, so every
  depth launches the same kernel and gives the same bits: each row says
  ``prefetch=ignored``, and :func:`dma_profile` checks the bits across
  depths and the output against B2's plain version (atol 2e-5, f32).
  The inputs are drawn with numpy (:func:`dma_case`), so the reference's
  Pallas kernel can be held to the same arrays.

By default the reference's model (reduced float32 smollm-360m with its
weights, ``llm_e2e.reference_model``); a caller may pass any config and
parameters.  ``REPRO_BENCH_SMOKE=1`` shrinks both sweeps to the
reference's smallest sizes.  Times are milliseconds: the engine rows the
host clock around the drain, the kernel rows CUDA events over back-to-back
launches on a card (``bench.common.kernel_ms``) and the host clock around
the plain version on the CPU.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import emit, kernel_ms, time_ms
from repro_torch.bench.llm_e2e import reference_model, refuse_mesh, smoke
from repro_torch.config import ServeConfig
from repro_torch.core import attention_api
from repro_torch.core.paged_kv import BlockAllocator
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine

# the fields of an engine row that count (equal across devices)
COUNTERS = ("steps", "idle_steps", "preempt", "finished")
DMA_ATOL = 2e-5          # B2's float32 rule
DMA_KV, DMA_HD, DMA_H = 2, 32, 8


def saturated_engine(model, params, cfg, *, overlap: bool, n_req: int,
                     max_batch: int, num_blocks: int, sanitize: bool = False,
                     device="cuda") -> ServingEngine:
    serve = ServeConfig(model=cfg.name, kv_block_size=8, max_batch=max_batch,
                        overlap=overlap, sanitize=sanitize)
    eng = ServingEngine(model, params, cfg, serve, num_blocks=num_blocks,
                        device=device)
    rng = np.random.default_rng(0)          # same wave for both passes
    for i in range(n_req):
        eng.submit(Request(
            req_id=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(4, 12)),), dtype=np.int32),
            max_new_tokens=int(rng.integers(6, 12))))
    return eng


def emit_saturation(tag: str, eng: ServingEngine,
                    dt: float) -> Dict[str, object]:
    m = eng.metrics()
    total = sum(m["phase_s"].values()) or 1.0
    return emit(tag, dt * 1e3,
                f"tok_s={m['throughput_tok_s']:.1f};"
                f"device_frac={m['phase_s'].get('device', 0.0) / total:.3f};"
                f"steps={m['steps']};"
                f"idle_steps={m['num_idle_steps']};"
                f"preempt={m['preemptions']};"
                f"finished={m['finished']};"
                f"overlap={str(m['overlap']).lower()};"
                f"prefetch_depth={m['prefetch_depth']};"
                f"sanitize={str(m['sanitize']['enabled']).lower()};"
                f"retraces={m['sanitize']['retraces']};"
                f"backend={m['backend']}")


def dma_sizes(quick: bool, is_smoke: bool):
    """(total keys, depths, pages) of the sweep: the reference's."""
    total_kv = 64 if is_smoke else (128 if quick else 512)
    depths = [0, 2] if is_smoke else ([0, 2, 4] if quick else [0, 2, 4, 8])
    pages = [8, 16] if (is_smoke or quick) else [8, 16, 32]
    return total_kv, depths, pages


def dma_case(bs: int, total_kv: int) -> Dict[str, np.ndarray]:
    """One sweep point's inputs as numpy arrays: three requests of half, a
    quarter and a quarter of ``total_kv`` keys in ``bs``-key pages (the
    allocator's BlockList, padded by two entries), one decode lane each at
    its last position, f32 pools and q from ``default_rng(0)``."""
    lens = [total_kv // 2, total_kv // 4, total_kv // 4]
    nb = sum(-(-L // bs) for L in lens) + 2
    al = BlockAllocator(num_blocks=nb, block_size=bs)
    for r, L in enumerate(lens):
        al.allocate(r, L)
    bl, br, bp, _ = al.build_block_list(list(range(len(lens))), max_total=nb)
    rng = np.random.default_rng(0)
    shape = (nb, bs, DMA_KV, DMA_HD)
    return {
        "q": rng.standard_normal((3, DMA_H, DMA_HD)).astype(np.float32),
        "pool_k": rng.standard_normal(shape).astype(np.float32),
        "pool_v": rng.standard_normal(shape).astype(np.float32),
        "block_list": np.asarray(bl, np.int32),
        "block_req": np.asarray(br, np.int32),
        "block_pos": np.asarray(bp, np.int32),
        "kv_lens": np.asarray(lens, np.int32),
        "token_req": np.asarray([0, 1, 2], np.int32),
        "token_pos": np.asarray([L - 1 for L in lens], np.int32),
    }


DMA_ARGS = ("q", "pool_k", "pool_v", "block_list", "block_req", "block_pos",
            "kv_lens", "token_req", "token_pos")


def dma_profile(quick: bool, is_smoke: bool,
                device) -> List[Dict[str, object]]:
    """B2 over depth x page at fixed keys (the reference's rows, plus
    ``prefetch=ignored``, ``max_abs_err`` against the plain version and
    ``same_bits_across_depths``); raises where B2 leaves the plain version
    or one depth's bits another's."""
    dev = device_lib.resolve(device)
    op = attention_api.paged_attention_chunked_op
    total_kv, depths, pages = dma_sizes(quick, is_smoke)
    rows = []
    for bs in pages:
        case = dma_case(bs, total_kv)
        args = [torch.from_numpy(case[k]).to(dev) for k in DMA_ARGS]
        plain = attention_api.paged_attention_chunked(*args)
        kv_pages = int(case["block_list"].shape[0])
        # per grid step (one KV page): K+V page bytes in, flash update flops
        kv_bytes = 2 * bs * DMA_KV * DMA_HD * 4
        flops = 2 * 2 * len(case["token_req"]) * DMA_H * bs * DMA_HD
        first = None
        for depth in depths:
            kw = dict(q_chunk=4, prefetch_depth=depth)
            out = op(*args, **kw)
            err = float((out - plain).abs().max())
            if not err <= DMA_ATOL:
                raise AssertionError(f"B2 page {bs} depth {depth}: "
                                     f"{err:.3g} from its plain version")
            if first is None:
                first = out
            elif not torch.equal(out, first):
                raise AssertionError(f"B2 page {bs}: depth {depth}'s bits "
                                     f"differ from depth {depths[0]}'s")
            ms = (kernel_ms(op, *args, device=dev, **kw)
                  if dev.type == "cuda" else
                  time_ms(lambda *a: op(*a, **kw), *args, device=dev))
            row = emit(f"paged_dma_profile_bs{bs}_d{depth}", ms,
                       f"depth={depth};page={bs};kv_pages={kv_pages};"
                       f"kv_bytes_per_step={kv_bytes};"
                       f"flops_per_step={flops};"
                       f"bytes_per_flop={kv_bytes / flops:.3f};"
                       f"prefetch=ignored")
            row.update(max_abs_err=err, same_bits_across_depths=True)
            rows.append(row)
    return rows


def run(device="cuda", quick: bool = True, cfg=None,
        params=None) -> List[Dict[str, object]]:
    """The module's rows: the saturated wave with overlap off then on, then
    the B2 sweep.  ``cfg`` and ``params`` default to the reference's model
    and weights."""
    refuse_mesh()
    dev = device_lib.resolve(device)
    is_smoke = smoke()
    if cfg is None:
        cfg, model, params = reference_model(dev)
    else:
        model = build_model(cfg, device=dev, remat=False)
    # offered load >> capacity: requests outnumber batch slots ~6x and the
    # pool holds well under the working set
    n_req = 6 if is_smoke else (12 if quick else 48)
    sanitize = os.environ.get("REPRO_SANITIZE") == "1"
    rows = []
    for overlap in (False, True):
        eng = saturated_engine(model, params, cfg, overlap=overlap,
                               n_req=n_req, max_batch=2, num_blocks=24,
                               sanitize=sanitize, device=dev)
        t0 = time.perf_counter()
        eng.run_until_done()
        dt = time.perf_counter() - t0
        if sanitize:
            san = eng.metrics()["sanitize"]
            if not (san["retraces"] == 0 and san["transfer_guard_trips"] == 0
                    and san["invariant_checks"] > 0):
                raise AssertionError(f"sanitized saturation: {san}")
        rows.append(emit_saturation(
            f"llm_saturation_overlap_{'on' if overlap else 'off'}", eng, dt))
        del eng
    return rows + dma_profile(quick, is_smoke, dev)
