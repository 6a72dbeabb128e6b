"""Paper Fig 17 a-c: PagedAttention, vLLM_base (padded BlockTable) against
vLLM_opt (flat BlockList), swept over the padding fraction, the batch and
the prefill chunk (port of ``benchmarks/paged_attention_bench.py``).

Base and opt are timed as their plain PyTorch versions
(``attention_api.paged_attention_base`` / ``paged_attention_opt``), as the
reference times its jnp forms; on a card the decode kernel
(``attention_api.paged_attention_op``) is timed beside them and the
chunked sweep times the chunked kernel.  The reference's XLA
``cost_analysis`` bytes become bytes counted from the shapes
(:func:`gathered_bytes`): base gathers all B x MAXB pages of K and V, opt
only the effectual ones.  Their ratio is the hardware-independent form of
the paper's 7.4x / 55.7x.  The layout sweep runs the same mixed
prefill+decode lanes through chunked (split pools) and ragged (fused pool)
and records whether they agree bitwise.  The reference's ragged autotune
sweep is not ported.

Times come from ``bench.common.time_ms`` and every row names its device.

    python -m repro_torch.bench.paged_attention_bench [--device cpu] [--quick]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import device_name, emit, time_ms
from repro_torch.core import attention_api as api
from repro_torch.core.paged_kv import (BlockAllocator, fuse_kv_heads,
                                      fused_kv_views)

# (B, BS, KV, HD, H, full_blocks): the reference's quick and full sizes.
SIZES = {True: (16, 16, 4, 64, 16, 16), False: (32, 16, 8, 128, 32, 64)}
PAD_FRACS = (0.0, 0.3, 0.6, 0.9)
BATCHES = {True: ((8, 8), (32, 16)),
           False: ((8, 8), (32, 16), (64, 32), (128, 64))}
CHUNKS = {True: (1, 4, 16), False: (1, 8, 64, 256)}
CHUNK_BATCH = {True: (4, 8), False: (16, 32)}       # (requests, blocks)
LAYOUTS = {True: ((4, 4), (8, 8)), False: ((4, 4), (8, 8), (16, 16))}


def _setup(B, seq_lens, max_blocks, NB, BS, KV, HD, H, gen, dev):
    """The reference's ``_setup``: a scrambled pool, per-request tables of
    ``seq_lens`` tokens, both layouts, random float32 q and pools."""
    al = BlockAllocator(num_blocks=NB, block_size=BS)
    al._free = np.random.RandomState(0).permutation(NB).tolist()
    for r, n in enumerate(seq_lens):
        al.allocate(r, n)
    tab, lens = al.build_block_table(list(range(B)), max_blocks=max_blocks)
    tot = sum(-(-n // BS) for n in seq_lens)
    bl, br, bp, lens2 = al.build_block_list(list(range(B)), max_total=tot)

    def up(a):
        return torch.from_numpy(a).to(dev)

    pool_k = torch.randn((NB, BS, KV, HD), generator=gen, device=dev)
    pool_v = torch.randn((NB, BS, KV, HD), generator=gen, device=dev)
    q = torch.randn((B, H, HD), generator=gen, device=dev)
    return (q, pool_k, pool_v, up(tab), up(lens), up(bl), up(br), up(bp),
            up(lens2))


def gathered_bytes(q, pool_k, pages: int, int_entries: int) -> int:
    """Bytes a decode call must move: ``pages`` K and V pages gathered, q
    read and the output written once, and ``int_entries`` int32 of
    tables or lists."""
    _, BS, KV, HD = pool_k.shape
    elt = pool_k.element_size()
    return (2 * pages * BS * KV * HD * elt + 2 * q.numel() * q.element_size()
            + 4 * int_entries)


def _times(dev, q, pk, pv, tab, lens, bl, br, bp, lens2):
    """(base, opt plain, opt kernel) ms; the kernel only on a card."""
    base = time_ms(api.paged_attention_base, q, pk, pv, tab, lens,
                   device=dev)
    opt = time_ms(api.paged_attention_opt, q, pk, pv, bl, br, bp, lens2,
                  device=dev)
    kernel = (time_ms(api.paged_attention_op, q, pk, pv, bl, br, bp, lens2,
                      device=dev) if dev.type == "cuda" else None)
    return base, opt, kernel


def _kernel_text(base: float, kernel: Optional[float]) -> str:
    if kernel is None:
        return "kernel_ms=not measured"
    return f"kernel_ms={kernel:.4f};kernel_speedup={base / kernel:.2f}"


def padding_sweep(dev, B, BS, KV, HD, H, full_blocks,
                  fracs=PAD_FRACS) -> List[Dict[str, object]]:
    """Fig 17b: every request at (1 - frac) of the longest length."""
    gen = torch.Generator(device=dev).manual_seed(0)
    where = device_name(dev)
    rows = []
    for frac in fracs:
        eff = max(1, int(round(full_blocks * (1 - frac))))
        args = _setup(B, [eff * BS] * B, full_blocks, B * full_blocks + 8,
                      BS, KV, HD, H, gen, dev)
        q, pk, _, tab, _, bl = args[:6]
        by_base = gathered_bytes(q, pk, tab.numel(), tab.numel() + B)
        by_opt = gathered_bytes(q, pk, bl.numel(), 3 * bl.numel() + B)
        base, opt, kernel = _times(dev, *args)
        pad = int(frac * 100)
        rows.append(emit(f"paged_base_pad{pad}", base,
                         f"bytes={by_base};device={where}"))
        row = emit(f"paged_opt_pad{pad}", opt,
                   f"bytes={by_opt};speedup={base / opt:.2f};"
                   f"bytes_ratio={by_base / by_opt:.2f};"
                   f"{_kernel_text(base, kernel)};device={where}")
        row.update(frac=frac, base_ms=base, opt_ms=opt, kernel_ms=kernel,
                   bytes_base=by_base, bytes_opt=by_opt,
                   bytes_ratio=by_base / by_opt)
        rows.append(row)
    return rows


def batch_sweep(dev, BS, KV, HD, H, sizes) -> List[Dict[str, object]]:
    """Fig 17a: batch and sequence length grown together, no padding."""
    gen = torch.Generator(device=dev).manual_seed(1)
    where = device_name(dev)
    rows = []
    for B, blocks in sizes:
        args = _setup(B, [blocks * BS] * B, blocks, B * blocks + 8, BS, KV,
                      HD, H, gen, dev)
        base, opt, kernel = _times(dev, *args)
        row = emit(f"paged_opt_B{B}_S{blocks * BS}", opt,
                   f"speedup_vs_base={base / opt:.2f};base_ms={base:.4f};"
                   f"{_kernel_text(base, kernel)};device={where}")
        row.update(batch=B, seq=blocks * BS, base_ms=base, opt_ms=opt,
                   kernel_ms=kernel)
        rows.append(row)
    return rows


def chunked_sweep(dev, BS, KV, HD, H, requests, blocks,
                  chunks) -> List[Dict[str, object]]:
    """One call prefills C prompt tokens per request against the paged
    pool (the engine's per-step shape): the cost per token should fall
    with C.  The chunked op: the kernel on a card, the plain version on
    the CPU."""
    gen = torch.Generator(device=dev).manual_seed(2)
    where = device_name(dev)
    S = blocks * BS
    _, pk, pv, _, _, bl, br, bp, lens = _setup(
        requests, [S] * requests, blocks, requests * blocks + 8, BS, KV, HD,
        H, gen, dev)
    rows = []
    for C in chunks:
        T = requests * C
        q = torch.randn((T, H, HD), generator=gen, device=dev)
        token_req = torch.arange(requests, dtype=torch.int32,
                                 device=dev).repeat_interleave(C)
        token_pos = torch.arange(S - C, S, dtype=torch.int32,
                                 device=dev).repeat(requests)
        ms = time_ms(api.paged_attention_chunked_op, q, pk, pv, bl, br, bp,
                     lens, token_req, token_pos, device=dev)
        plain_ms = time_ms(api.paged_attention_chunked, q, pk, pv, bl, br,
                           bp, lens, token_req, token_pos, device=dev)
        what = "kernel" if dev.type == "cuda" else "plain"
        row = emit(f"paged_chunked_C{C}", ms,
                   f"tokens={T};us_per_token={1e3 * ms / T:.3f};op={what};"
                   f"plain_ms={plain_ms:.4f};device={where}")
        row.update(chunk=C, tokens=T, us_per_token=1e3 * ms / T,
                   plain_ms=plain_ms)
        rows.append(row)
    return rows


def _ragged_setup(B, pages_per_seq, BS, KV, HD, H, gen, dev):
    """The reference's mixed workload in both forms: even slots one decode
    lane, odd slots a 4-token prefill chunk, lengths not page-aligned.
    Returns the chunked op's args (split pools) and the ragged op's (the
    same values in the fused pool)."""
    seq_lens = [pages_per_seq * BS - (r % BS) for r in range(B)]
    NB = B * pages_per_seq + 4
    al = BlockAllocator(num_blocks=NB, block_size=BS)
    al._free = np.random.RandomState(0).permutation(NB).tolist()
    for r, n in enumerate(seq_lens):
        al.allocate(r, n)
    tot = sum(-(-n // BS) for n in seq_lens)
    bl, br, bp, kv_lens = (torch.from_numpy(a).to(dev) for a in
                           al.build_block_list(list(range(B)),
                                               max_total=tot))
    pool = fuse_kv_heads(
        torch.randn((NB, BS, KV, HD), generator=gen, device=dev),
        torch.randn((NB, BS, KV, HD), generator=gen, device=dev))
    pk, pv = fused_kv_views(pool)
    n_q = [1 if r % 2 == 0 else min(4, seq_lens[r]) for r in range(B)]
    q = torch.randn((sum(n_q), H, HD), generator=gen, device=dev)
    token_req = np.repeat(np.arange(B, dtype=np.int32), n_q)
    token_pos = np.concatenate([np.arange(n - c, n, dtype=np.int32)
                                for c, n in zip(n_q, seq_lens)])
    cu_q = np.zeros((B + 1,), np.int32)
    cu_q[1:] = np.cumsum(n_q)
    cu_kv = np.zeros((B + 1,), np.int32)
    cu_kv[1:] = np.cumsum(seq_lens)

    def up(a):
        return torch.from_numpy(a).to(dev)

    chunked = (q, pk, pv, bl, br, bp, kv_lens, up(token_req),
               up(token_pos))
    ragged = (q, pool, bl, br, bp, up(cu_q), up(cu_kv),
              torch.arange(B, dtype=torch.int32, device=dev))
    return chunked, ragged


def layout_sweep(dev, sizes, BS=16, KV=4, HD=64,
                 H=8) -> List[Dict[str, object]]:
    """Fused pool (ragged op) against split views (chunked op) on the same
    lanes: whether they agree bitwise, and both times."""
    gen = torch.Generator(device=dev).manual_seed(3)
    where = device_name(dev)
    rows = []
    for B, pages in sizes:
        chunked, ragged = _ragged_setup(B, pages, BS, KV, HD, H, gen, dev)
        split = api.paged_attention_chunked_op(*chunked)
        fused = api.paged_attention_ragged_op(*ragged)
        diff = (split.float() - fused.float()).abs().max().item()
        us_split = 1e3 * time_ms(api.paged_attention_chunked_op, *chunked,
                                 device=dev)
        us_fused = 1e3 * time_ms(api.paged_attention_ragged_op, *ragged,
                                 device=dev)
        T = chunked[0].shape[0]
        row = emit(f"ragged_layout_B{B}_p{pages}", us_fused / 1e3,
                   f"layout=fused;tokens={T};us_split={us_split:.1f};"
                   f"speedup_vs_split={us_split / us_fused:.2f};"
                   f"bitwise={int(torch.equal(split, fused))};"
                   f"max_abs_diff={diff:.3e};device={where}")
        row.update(bitwise=torch.equal(split, fused), max_abs_diff=diff,
                   us_split=us_split, us_fused=us_fused)
        rows.append(row)
    return rows


def run(device="cuda", quick: bool = False) -> List[Dict[str, object]]:
    """All four sweeps at the reference's quick or full sizes."""
    dev = device_lib.resolve(device)
    B, BS, KV, HD, H, full_blocks = SIZES[quick]
    requests, blocks = CHUNK_BATCH[quick]
    return (padding_sweep(dev, B, BS, KV, HD, H, full_blocks)
            + batch_sweep(dev, BS, KV, HD, H, BATCHES[quick])
            + chunked_sweep(dev, BS, KV, HD, H, requests, blocks,
                            CHUNKS[quick])
            + layout_sweep(dev, LAYOUTS[quick]))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' times the plain versions")
    p.add_argument("--quick", action="store_true",
                   help="the reference's quick sizes")
    args = p.parse_args(argv)
    run(args.device, quick=args.quick)


if __name__ == "__main__":
    main()
