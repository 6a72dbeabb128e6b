#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: ``python3 chip_smoke.py`` from the repo root.

Phases, each of which raises on failure (the script catches none):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the seven CUDA sources of ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together;
3. the ragged paged-attention kernel against its plain PyTorch version at
   smollm-360m's widths (H=15, KV=5, hd=64, BS=16) on mixed prefill+decode
   lanes with padding lanes and empty entries, and on the shared
   long-owner cases (hd 16, G = 3 and 4: a prefill chunk mid-sequence
   whose rows span more than one 128-row tensor-core tile, decode lanes, a
   two-lane owner, a shuffled BlockList): float32 (atol 2e-5) and bfloat16
   (atol 2e-2, and every element within 2^-7 (M + |want|) + 1e-4 of the
   plain version on float32 q and k, as flash in phase 21, which the
   outputs under 0.25 moved by 8 ulps must fail);
4. a small-input reference: reduced smollm-360m in float32 served on the
   card and on the CPU (the plain path): one fused step's logits agree
   (atol 1e-3) and the greedy streams are identical;
5. serving: full-width smollm-360m (32 layers, bf16, random weights from a
   seeded generator on the card), 16 requests with 128-1024-token prompts
   (every fourth prompt longer than 512 opens with a shared 256-token
   prefix), 32 new tokens each, max_batch 16, 16-token KV blocks in a
   4096-block pool.  The kernel's launch count
   must equal steps x 32, the allocator's invariants must hold and the
   pool must drain; the prefill-only, mixed and decode-only steps and the
   kernel's launches in each are printed.  Layer 0's attention inputs of
   one mixed step and one decode-only step are captured on the way;
6. the kernel against the plain version on the captured inputs of the
   decode step and the mixed step (bf16, atol 2e-2 and the per-element
   limit of phase 3), then times of each: the kernel (CUDA events over
   back-to-back launches) and its TFLOP/s beside the plain version and
   both bounds, the bytes (the K/V rows of the step's keys, q, out and the
   lists at 3.35 TB/s) and the operations (4 hd per (head, valid key) at
   the bf16/f32 peak), with the share of the larger; then the registers,
   shared memory and spills of every ragged instance (``-Xptxas -v``; a
   spill fails the phase);
7. torch.profiler over three decode-only steps, then over phase 5's first
   mixed step (its requests anew): wall, the device's busy share and the
   attention kernel's device ms;
8. the BatchedTable embedding-bag kernel against its plain version at
   RM1's and RM2's full widths (10 M x 128 with L = 10, 20 M x 64 with
   L = 20; tables past 2^31 bytes), 4096 x T bags with uniform ids, ids
   in the table's top rows, a wrapped negative id and an id past the end:
   float32 (atol 1e-5) and bfloat16 (atol 2e-2), NaN bags where expected;
9. a small-input reference: rm2 with 4096 rows per table in float32, one
   forward on the card and on the CPU (the plain path), logits atol 1e-4;
10. DLRM inference at full width: ``repro_torch.bench.recsys_e2e`` runs
   rm1 and rm2 (1 M rows per table, float32, seeded random weights on the
   card), SingleTable and BatchedTable, batch 16 to 4096.  The embedding
   kernel's launch count must equal the BatchedTable forwards run, and
   every logit must be finite;
11. the embedding kernel at the main path's B = 4096 inputs of rm1 and
   rm2: its time (CUDA events over back-to-back launches) beside the plain
   version, ``F.embedding_bag`` on the same inputs (timed as a yardstick,
   never used by the port) and the bound (the distinct rows gathered, the
   ids and the output at 3.35 TB/s).
12. the chunked paged-attention kernel against its plain version at
   smollm-360m's widths: owners interleaved within a tile, an empty
   request, runs longer than a tile, padding lanes, the pool given as the
   fused pool's strided views, ``q_chunk`` 16 and 4, ``prefetch_depth`` 0
   and 2: float32 (atol 2e-5) and bfloat16 (atol 2e-2); then phase 3's
   lanes (all its cases) through the chunked kernel at ``q_chunk`` 16 and
   4 and the ragged kernel, which must agree bitwise (the max difference
   is printed where they do not);
13. the decode kernel against ``paged_attention_opt`` (plain) at the same
   widths, with a request that has no entry (it must read 0), padding
   entries, and a sorted and a shuffled BlockList; same tolerances;
14. a small-input reference: reduced smollm-360m in float32, card against
   CPU: the chunked engine's greedy streams are identical on both and to
   phase 4's ragged streams; ``decode_step_paged`` logits on the card
   match the CPU (atol 1e-3) and the card's ``forward`` (atol 3e-3);
15. serving with ``attn_impl="chunked"``: phase 5's 16 requests at full
   width.  The greedy streams must equal phase 5's, the chunked kernel's
   launch count steps x 32 (steps and launches by kind printed), and the
   pool must drain.  Layer 0's inputs of one mixed and one decode-only
   step are captured.  Then the workload runs four more times, ragged and
   chunked in turns, for their TPOT;
16. the paper path at full width: ``decode_step_paged`` over split pools
   for 16 requests, 128 prompt tokens fed one per step, then 32 greedy
   tokens; the decode kernel's launch count must be steps x 32.  Per-step
   ms; layer 0's inputs of the last step are captured;
17. ``repro_torch.bench.paged_attention_bench`` at the reference's full
   sizes (paper Fig 17 a-c): base, opt-plain and opt-kernel ms and the
   bytes ratio per padding fraction and per batch, the chunked kernel's
   us per token per chunk, and chunked against ragged on the fused-pool
   workloads;
18. the chunked and decode kernels' times on the inputs captured in
   phases 15 and 16 (CUDA events over back-to-back launches) and their
   TFLOP/s beside their plain versions and both bounds (the K/V rows the
   owners hold, q, out and the lists at 3.35 TB/s; operations at the
   dtype's peak), the chunked kernel also held to phase 3's per-element
   limit; then every chunked instance's registers, shared memory and
   spills (a spill fails the phase);
19. the STREAM kernels against their plain versions, bitwise: ADD, SCALE
   and TRIAD at ``block_rows`` 8/64/256/1024 on 2^21 elements (the
   reference's full size) and at 256 on 2^28, then at the edges of the
   persistent grid (``kernels/stream/cases.edge_shapes``: one row, fewer
   tiles than SMs, a tile count that is not a multiple of the grid, tiles
   larger than a 16 KiB unit and tiles that end in part of one;
   two calls must give the same bits), float32 and bfloat16, with a
   scalar that bfloat16 must round;
20. the gather and scatter kernels against their plain versions, bitwise,
   at Fig 9's full sizes (4 M rows, 1 M uniform ids, about 115 k of them
   repeats): rows of 16 to 2048 bytes (the widest table 8.2 GB, past 2^31
   bytes), 12-byte float32 and 10-byte bfloat16 rows (element loads),
   48-byte rows (three 16-byte vectors: a masked lane group), and heavy
   repeats (1 M draws over 16 rows) at 16 and 2048 bytes; ids that wrap,
   fall past either end (NaN rows, dropped writes) and repeat;
21. the flash-attention kernel against its plain version at smollm-360m's
   prefill widths (B 1, S 4096, H 15, KV 5, hd 64; bf16 and f32), Fig
   17's (B 4, S 2048, H 32, KV 8, hd 128; bf16), the four shapes of
   ``tests/test_kernels.py`` and four bf16 shapes of the tensor-core tile
   (G = H / KV of 1, 3 and 8; S 65 and 1000; hd 16 to 128), causal and
   not: float32 atol 2e-5; bfloat16 atol 2e-2, and every element within
   2^-7 (M + |want|) + 1e-4 of the plain version on float32 q and k (M:
   the same on |v|), which a control (the outputs under 0.25 moved by 8
   ulps) must fail; ``bq``/``bk`` 64 (or S) and 512, two calls, must give
   the same bits;
22. the microbenchmark path: ``python -m repro_torch.bench.run --only
   stream,gather_scatter,gemm_roofline --full`` in-process (Fig 8 at the
   reference's 2^21 elements, Fig 9 at 4 M x 1 M, each gather and
   scatter held bitwise against its plain version before it is timed, the
   GEMM sweep), then the STREAM module at n = 2^28 (1 GiB per array, over
   4x the 50 MB L2); each STREAM and gather/scatter wrapper's launch count
   must equal the calls its rows made.  A Fig 8 row whose bytes fit in the
   L2 prints "in L2" and no share of the HBM's rate; every other one must
   be at least four times the L2 (STREAM's rule);
23. the flash-attention op at the shapes of phase 21 (causal where the
   reference's are); its launch count must equal the calls, and every
   output must be finite;
24. the three new kernels' times (CUDA events over back-to-back launches
   through the C entry point) beside their plain versions, one PyTorch
   call each as the yardstick (``torch.add``/``mul``, ``index_select``/
   the deterministic ``index_put_``, ``scaled_dot_product_attention``;
   never used by the port) and their bounds: STREAM 3 n elt (2 n elt for
   SCALE) bytes, at n = 2^28 in float32 and bfloat16, with the grid each
   call launched and every ``stream_kernel`` instance's registers, shared
   memory and spills (a spill fails the phase); gather the distinct rows
   read, N rows written and the ids; scatter the distinct rows' winning
   source rows read, the distinct rows written and the ids; beside those,
   Fig 9's sector bound (the same accesses in 32-byte sectors, and a read
   of each sector the scatter writes only in part).  The scatter's yardstick is the deterministic
   ``index_put_`` where it gives the plain version's bits, else none (it
   says so), with ``index_copy_`` (no last-write rule) beside it either
   way.  One gather and one scatter call at 16 and 2048 B under
   torch.profiler give each launch's device ms, and every gather/scatter
   instance's registers and spills are printed (a spill fails the phase);
   flash q, k, v and out once, against 4 B H S^2 hd operations (half when
   causal) at the dtype's peak, with its TFLOP/s and its time over SDPA's,
   and the registers, shared memory and spills of every ``flash_kernel``
   instance (``-Xptxas -v``; a spill fails the phase).  Each kernel is
   held against its plain version on the inputs it is timed on.  Parent
   and change of the gather/scatter kernels in turns on one card are
   ``src/repro_torch/bench/gather_scatter_turns.py``'s job: a checkout
   holds one tree.

Each path (phases 5, 10, 15, 16, 22, 23) runs with every kernel's launch
count set to 0 just before it and read just after.  The card's peaks come
from ``repro_torch.roofline.analysis.HW``.

The ragged and chunked kernels run bf16 prefill owners (two or more lanes)
on the tensor-core tile and everything else on the SIMT tile; their JSON
records say so in ``tile`` and carry the mixed and decode steps' times,
steps and launches.  The line before the last is the kernels' JSON
record; the last line is
``{"ok": true, "device": {...}}``.  Without a card the script exits
nonzero before printing either.
"""
from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.bench.common import device_ms, kernel_ms  # noqa: E402
from repro_torch.bench.turns import card_line  # noqa: E402
from repro_torch.roofline.analysis import H100  # noqa: E402

HBM_BYTES_PER_S = H100.hbm_bw
PEAK_OPS = {"torch.bfloat16": H100.peak_bf16, "torch.float32": H100.peak_f32}
KERNEL = "paged_attention_ragged"
EMB_KERNEL = "batched_embedding"
CHUNKED_KERNEL = "paged_attention_chunked"
DECODE_KERNEL = "paged_attention_decode"
STREAM_KERNEL = "stream"
GS_KERNEL = "gather_scatter"
FLASH_KERNEL = "flash_attention"
SOURCES = [KERNEL, CHUNKED_KERNEL, DECODE_KERNEL, EMB_KERNEL, STREAM_KERNEL,
           GS_KERNEL, FLASH_KERNEL]
PAPER_PROMPT, PAPER_NEW = 128, 32
FULL_WIDTHS = dict(num_heads=15, num_kv=5, head_dim=64, block_size=16,
                   num_blocks=256)
RAGGED_CASE = dict(seqs=[(3, 1, 300), (0, 37, 37), (5, 1, 17),
                         (1, 120, 250), (2, 1, 1), (4, 64, 700), (8, 0, 0),
                         (8, 0, 0)],
                   num_lanes=256, num_entries=160, shuffle=True)
# owners interleaved in a tile, an empty request (slot 2), runs longer than
# a tile, padding lanes (owner 6)
CHUNKED_CASE = dict(kv_lens=[300, 37, 0, 250, 17, 700],
                    lanes=[(0, 299), (3, 130), (0, 298), (4, 16), (2, 0),
                           (5, 650)] + [(1, p) for p in range(37)]
                    + [(3, p) for p in range(130, 250)]
                    + [(5, p) for p in range(636, 700)] + [(6, 0)] * 16,
                    num_entries=160, shuffle=True)
DECODE_CASE = dict(seq_lens=[300, 1, 0, 250, 16, 17, 700, 33],
                   num_entries=160)
DTYPES = (("float32", 2e-5), ("bfloat16", 2e-2))
# the kernels JSON line's "tile" of the ragged and chunked kernels, and of
# the decode kernel
PAGED_TILE = ("bf16 owners of >= 2 lanes: attend_tile_mma (wgmma at hd "
              "64/128, mma.sync at 16/32); owners of 1 lane (decode "
              "lanes), f32 or bf16: the decode tile (splits of 256 keys, "
              "combined in the launch); f32 owners of >= 2 lanes and "
              "padding: attend_tile (SIMT)")
DECODE_TILE = ("the decode tile: one block per (split of 256 keys, kv head),"
               " the splits combined in the launch")
EMB_BATCH = 4096
SERVE_BLOCKS, SERVE_BS, SERVE_BATCH, SERVE_NEW = 4096, 16, 16, 32
STREAM_N = (128 * 16384, 2 ** 28)    # the reference's full n; 1 GiB f32
STREAM_BLOCK_ROWS = (8, 64, 256, 1024)
# the stream_kernel instances' template arguments, as the compiler mangles
# them
STREAM_DTYPES = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
STREAM_OPS = ("ADD", "SCALE", "TRIAD")
FIG9_R, FIG9_N = 4_000_000, 1_000_000
# (row bytes, dtype, ids): Fig 9's widths, 12-byte float32 and 10-byte
# bfloat16 rows (element loads), 48-byte rows (three 16-byte vectors, a
# masked lane group), then heavy repeats: 1 M draws over 16 rows
FIG9_ROWS = ((16, "float32", "uniform"), (64, "float32", "uniform"),
             (128, "float32", "uniform"), (256, "float32", "uniform"),
             (512, "float32", "uniform"), (2048, "float32", "uniform"),
             (12, "float32", "uniform"), (10, "bfloat16", "uniform"),
             (48, "float32", "uniform"), (16, "float32", "heavy"),
             (2048, "float32", "heavy"))
HEAVY_ROWS = 16
# the gather/scatter instances' word types, as the compiler mangles them
GS_WORDS = {"5uint4": "uint4", "j": "uint32", "t": "uint16"}
# (name, B, S, H, KV, hd, dtype, causal): smollm-360m's prefill, Fig 17's
# widths, then tests/test_kernels.py's four shapes
FLASH_SHAPES = (("smollm-360m prefill", 1, 4096, 15, 5, 64, "bfloat16", True),
                ("Fig 17 widths", 4, 2048, 32, 8, 128, "bfloat16", True),
                ("test 1", 2, 128, 4, 2, 64, "float32", True),
                ("test 2", 1, 256, 6, 6, 64, "float32", False),
                ("test 3", 2, 64, 8, 2, 128, "float32", True),
                ("test 4", 1, 128, 4, 4, 64, "bfloat16", True))
# phase 21: those, smollm-360m's prefill in float32, and the bf16
# tensor-core tile at G = H / KV of 1, 3 and 8, S = 65 (a 64-key stage's
# one-key tail) and 1000, hd 16 to 128
FLASH_CHECK_SHAPES = FLASH_SHAPES + (
    ("smollm-360m prefill", 1, 4096, 15, 5, 64, "float32", True),
    ("G 1 S 65", 2, 65, 8, 8, 64, "bfloat16", True),
    ("G 3 S 65", 2, 65, 6, 2, 128, "bfloat16", True),
    ("G 8 S 65", 2, 65, 8, 1, 16, "bfloat16", True),
    ("G 8 S 1000", 2, 1000, 16, 2, 32, "bfloat16", True))


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(torch, got, want, atol, what):
    err = (got.float() - want.float()).abs().max().item()
    log(f"  {what}: max_abs_err {err:.3e} (atol {atol:g})")
    if not err <= atol:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version: {err} > {atol}")
    return err


def compare_flash(torch, got, q, k, v, causal, what):
    """``got`` against the plain version: f32 atol 2e-5; bf16 atol 2e-2,
    then :func:`bf16_share` at most 1.  Returns (max_abs_err, share or
    None)."""
    from repro_torch.kernels.flash_attention.ref import (bf16_share,
                                                         flash_attention_ref)

    want = flash_attention_ref(q, k, v, causal=causal)
    if got.dtype == torch.float32:
        return compare(torch, got, want, 2e-5, what), None
    err = compare(torch, got, want, 2e-2, what)
    share = bf16_share(got, q, k, v, causal)
    log(f"    on f32 q, k: largest |err| / (2^-7 (M + |want|) + 1e-4) "
        f"{share:.4f}")
    if not share <= 1:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version on f32 q, k by {share:.3f}x the limit")
    return err, share


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def _clone(t):
    """A copy with the same strides (a split view of the fused pool stays
    strided, so a timed kernel reads memory as it did in the run)."""
    if t.is_contiguous():
        return t.clone()
    c = t.new_empty_strided(t.size(), t.stride())
    return c.copy_(t)


class Capture:
    """Clone layer 0's inputs, keyword arguments and output of the op
    ``api.<attr>``: for the first mixed and the first decode-only step the
    engine runs (``engine`` given), or for a call armed by :meth:`arm`.
    With an engine it also counts the steps of each kind (prefill-only,
    mixed, decode-only) and the op's kernel launches in each kind."""

    def __init__(self, api, attr, engine=None):
        self.api, self.attr, self.engine = api, attr, engine
        self.want = None
        self.got = {}
        self.kind = None
        self.steps, self.launches = {}, {}
        self._op = getattr(api, attr)
        setattr(api, attr, self.op)
        if engine is not None:
            self._render = engine._render
            engine._render = self.render

    def arm(self, kind):
        self.want = kind

    def render(self, plan):
        kind = ("mixed" if plan.decode and plan.prefill else
                "decode" if plan.decode else "prefill")
        self.kind = kind
        self.steps[kind] = self.steps.get(kind, 0) + 1
        self.want = (kind if kind != "prefill" and kind not in self.got
                     else None)
        return self._render(plan)

    def op(self, *args, **kw):
        before = self._op.launches
        out = self._op(*args, **kw)
        if self.kind is not None:
            self.launches[self.kind] = (self.launches.get(self.kind, 0)
                                        + self._op.launches - before)
        if self.want is not None:
            self.got[self.want] = ([_clone(a) for a in args], dict(kw),
                                   out.clone())
            self.want = None
        return out

    def by_kind(self):
        """'prefill N steps / L launches, ...' for the kinds seen."""
        return ", ".join(f"{k} {self.steps[k]} steps / "
                         f"{self.launches.get(k, 0)} launches"
                         for k in ("prefill", "mixed", "decode")
                         if k in self.steps)

    def close(self):
        if self.engine is not None:
            self.engine._render = self._render
        setattr(self.api, self.attr, self._op)


def reset_counts(counted):
    """Every kernel wrapper's launch count to 0 (``counted`` holds the
    wrappers themselves: a Capture puts a function in their place)."""
    for op in counted:
        op.launches = 0


def synthetic_cases():
    """(name, ragged_case keyword arguments) of phases 3 and 12: mixed
    lanes at smollm-360m's widths, then the long-owner cases (a prefill
    chunk mid-sequence whose rows span more than one 128-row tensor-core
    tile, decode lanes, a two-lane owner, a shuffled BlockList) at G = 3
    and G = 4."""
    from repro_torch.kernels.paged_attention.cases import SMALL, SMALL_CASES

    return [("smollm-360m widths", dict(FULL_WIDTHS, **RAGGED_CASE))] + [
        (name, dict(SMALL, **SMALL_CASES[name]))
        for name in ("long_owner", "long_owner_g4")]


def lanes_by_sequence(cu_q, cu_kv):
    """[(nq, kvl), ...] of the non-empty sequences of a ragged call."""
    cu_q, cu_kv = cu_q.tolist(), cu_kv.tolist()
    return [(cu_q[j + 1] - cu_q[j], cu_kv[j + 1] - cu_kv[j])
            for j in range(len(cu_q) - 1) if cu_q[j + 1] > cu_q[j]]


def ragged_bound(torch, inputs):
    """:func:`bounds` of one ragged call: the K/V rows of the keys
    each live sequence holds (``kv_len`` rows, not whole pages) + q of the
    real lanes + out + the int32 lists, over HBM rate, against 4*hd
    operations per (head, valid key) pair over the dtype's peak."""
    q, pool, bl, _, _, cu_q, cu_kv, ss = inputs
    T, H, HD = q.shape
    KV2 = pool.shape[2]
    elt = q.element_size()
    cu_q, cu_kv, ss = cu_q.cpu().numpy(), cu_kv.cpu().numpy(), ss.cpu().numpy()
    S = len(ss)
    rows = keys = 0
    for j in range(S):
        nq, kvl = cu_q[j + 1] - cu_q[j], cu_kv[j + 1] - cu_kv[j]
        if not 0 <= ss[j] < S or nq <= 0:
            continue
        rows += int(kvl)
        first = kvl - nq + 1                  # keys seen by the first lane
        keys += int(nq * first + nq * (nq - 1) // 2)
    nbytes = (rows * KV2 * HD * elt + int(cu_q[-1]) * H * HD * elt
              + T * H * HD * elt + 4 * (3 * len(bl) + 3 * S + 2))
    return bounds(nbytes, 4 * HD * H * keys, q.dtype)


def roofline(nbytes, ops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(dtype)]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bounds(nbytes, ops, dtype):
    """The roofline of one call, both ways: ``bound_ms``/``bound_by`` (the
    larger), ``bytes_ms`` and ``ops_ms``, and the operations."""
    bound_ms, bound_by = roofline(nbytes, ops, dtype)
    return dict(bound_ms=bound_ms, bound_by=bound_by, ops=ops,
                bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                ops_ms=1e3 * ops / PEAK_OPS[str(dtype)])


def chunked_bound(torch, inputs):
    """:func:`bounds` of one chunked call: the K/V rows each owner
    of a real lane holds, q of the real lanes, out of all lanes and the
    int32 lists, against 4*hd operations per (head, valid key) pair."""
    q, pk, _, bl, _, _, kv_lens, treq, tpos = inputs
    T, H, HD = q.shape
    KV = pk.shape[2]
    import numpy as np

    kvl = kv_lens.cpu().numpy().astype(np.int64)
    treq, tpos = treq.cpu().numpy(), tpos.cpu().numpy().astype(np.int64)
    real = (treq >= 0) & (treq < len(kvl))
    owners = np.unique(treq[real])
    rows = int(kvl[owners].sum())
    keys = int(np.minimum(tpos[real] + 1, kvl[treq[real]]).clip(0).sum())
    elt = q.element_size()
    nbytes = (rows * 2 * KV * HD * elt + int(real.sum()) * H * HD * elt
              + T * H * HD * elt + 4 * (3 * len(bl) + len(kvl) + 2 * T))
    return bounds(nbytes, 4 * HD * H * keys, q.dtype)


def decode_bound(torch, inputs):
    """:func:`bounds` of one decode call: each request's K/V rows, q,
    out and the int32 lists, against 4*hd operations per (head, key)."""
    q, pk, _, bl, _, _, seq_lens = inputs
    B, H, HD = q.shape
    KV = pk.shape[2]
    rows = int(seq_lens.clamp_min(0).sum().item())
    elt = q.element_size()
    nbytes = (rows * 2 * KV * HD * elt + 2 * B * H * HD * elt
              + 4 * (3 * len(bl) + B))
    return bounds(nbytes, 4 * HD * H * rows, q.dtype)


def reference_check(torch, np, cfg_mod, build_model, engine_mod,
                    attn_impl="ragged"):
    """Reduced float32 smollm-360m on the card and on the CPU: one fused
    step's logits on the same rendered lists, and whole greedy streams
    (returned)."""
    cfg = cfg_mod.get_config("smollm-360m").reduced(dtype="float32")
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=4, max_batch=4,
                                prefill_chunk=16, attn_impl=attn_impl)
    params_cpu = build_model(cfg, device="cpu").init(0)

    def engine(dev):
        eng = engine_mod.ServingEngine(
            build_model(cfg, device=dev), to_device(params_cpu, dev), cfg,
            serve, num_blocks=64, device=dev)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(engine_mod.Request(
                req_id=i, prompt=rng.integers(0, cfg.vocab_size, (5 + 4 * i,),
                                              dtype=np.int32),
                max_new_tokens=8, arrival=float(i)))
        return eng

    streams, logits = {}, {}
    for dev in ("cpu", "cuda"):
        eng = engine(dev)
        for _ in range(2):
            eng.step()
        lists, tokens, _, _ = eng._render(eng.scheduler.schedule())
        logits[dev], _ = eng.model.decode_tokens_paged(
            eng.params, eng.pools,
            {k: torch.from_numpy(v).to(dev) for k, v in lists.items()},
            torch.from_numpy(tokens).to(dev), attn_impl=attn_impl)
        eng = engine(dev)
        eng.run_until_done()
        streams[dev] = {r.req_id: list(r.output) for r in eng.finished}
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    log(f"  reduced f32 fused step ({attn_impl}), card vs CPU: logits "
        f"max_abs_err {err:.3e} (atol 1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"card logits disagree with the CPU: {err}")
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"greedy streams differ: {streams}")
    log(f"  greedy streams identical on card and CPU "
        f"({len(streams['cuda'])} requests x 8 tokens)")
    return streams["cuda"]


def step_lists(torch, alloc, n, max_total, dev):
    """The paper path's per-step lists for requests ``0..n-1``: the next
    token's slots (reserved) and the flat BlockList, on ``dev``."""
    slots = alloc.write_slots(list(range(n)))
    bl, br, bp, lens = alloc.build_block_list(list(range(n)), max_total)
    return {k: torch.from_numpy(v).to(dev) for k, v in dict(
        block_list=bl, block_req=br, block_pos=bp, seq_lens=lens,
        slots=slots).items()}


def paper_reference_check(torch, np, cfg_mod, build_model, dev):
    """Reduced float32 smollm-360m: decode_step_paged over 12 tokens of 2
    requests on the card and on the CPU, and the card's forward."""
    from repro_torch.core.paged_kv import BlockAllocator, make_pool

    cfg = cfg_mod.get_config("smollm-360m").reduced(dtype="float32")
    a = cfg.attention
    params_cpu = build_model(cfg, device="cpu").init(0)
    B, S, BS = 2, 12, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    logits = {}
    for d in ("cpu", dev):
        model = build_model(cfg, device=d)
        params = to_device(params_cpu, d)
        pk, pv = make_pool(cfg.num_layers, 16, BS, a.num_kv_heads,
                           a.head_dim, torch.float32, d)
        pools = {"k": pk, "v": pv}
        alloc = BlockAllocator(num_blocks=16, block_size=BS)
        for r in range(B):
            alloc.allocate(r, 0)
        outs = []
        for t in range(S):
            lists = step_lists(torch, alloc, B, 8, d)
            lg, pools = model.decode_step_paged(
                params, pools, lists, torch.from_numpy(toks[:, t]).to(d),
                num_lanes=B)
            outs.append(lg)
            for r in range(B):
                alloc.commit_token(r)
        logits[str(d)] = torch.stack(outs, 1).cpu()
    fwd, _ = model.forward(params, torch.from_numpy(toks).to(dev))
    compare(torch, logits[str(dev)], logits["cpu"], 1e-3,
            "reduced f32 decode_step_paged logits, card vs CPU")
    compare(torch, logits[str(dev)], fwd.cpu(), 3e-3,
            "reduced f32 decode_step_paged vs forward on the card")


def chunked_check(torch, np, api, ragged_case, dev):
    """Phase 12; returns (largest error against the plain version, largest
    difference from the ragged kernel on phase 3's lanes)."""
    from repro_torch.core.paged_kv import fused_kv_views
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, CHUNKED_ARG_ORDER, chunked_case)

    c = chunked_case(np.random.default_rng(0), **FULL_WIDTHS,
                     **CHUNKED_CASE)
    kvl = np.append(c["kv_lens"], 0)
    dead = torch.from_numpy(
        kvl[np.minimum(c["token_req"], len(c["kv_lens"]))] == 0).to(dev)
    errs = []
    for name, atol in DTYPES:
        dtype = getattr(torch, name)
        q = torch.from_numpy(c["q"]).to(dev, dtype)
        pool = torch.from_numpy(c["kv_pool"]).to(dev, dtype)
        args = [q, *fused_kv_views(pool),
                *[torch.from_numpy(c[k]).to(dev) for k in CHUNKED_ARG_ORDER]]
        want = api.paged_attention_chunked(*args)
        outs = []
        for q_chunk, depth in ((16, 0), (16, 2), (4, 2)):
            got = api.paged_attention_chunked_op(*args, q_chunk=q_chunk,
                                                 prefetch_depth=depth)
            torch.cuda.synchronize()
            errs.append(compare(
                torch, got, want, atol,
                f"{name} T={q.shape[0]} B={len(c['kv_lens'])} "
                f"Tb={len(c['block_list'])} q_chunk={q_chunk} "
                f"prefetch_depth={depth}"))
            if torch.any(got[dead] != 0):
                raise AssertionError("padding lanes and the empty request "
                                     "must read 0")
            outs.append(got)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError("q_chunk or prefetch_depth changed the "
                                 "result")
    log("  padding lanes and the empty request read 0; q_chunk and "
        "prefetch_depth change no bit of the result")
    diffs = []
    for case_name, shape in synthetic_cases():
        c = ragged_case(np.random.default_rng(0), **shape)
        for name, _ in DTYPES:
            dtype = getattr(torch, name)
            args = [torch.from_numpy(c[k]).to(dev) for k in ARG_ORDER]
            args[:2] = [a.to(dtype) for a in args[:2]]
            q, pool, bl, br, bp, cu_q, cu_kv, ss = args
            ragged = api.paged_attention_ragged_op(*args)
            treq, tpos, kvl = api.ragged_lane_metadata(
                cu_q, cu_kv, ss, q.shape[0], ss.shape[0])
            outs = [api.paged_attention_chunked_op(
                q, *fused_kv_views(pool), bl, br, bp, kvl, treq, tpos,
                q_chunk=q_chunk) for q_chunk in (16, 4)]
            torch.cuda.synchronize()
            diff = max((o.float() - ragged.float()).abs().max().item()
                       for o in outs)
            same = all(torch.equal(o, ragged) for o in outs)
            log(f"  {case_name} {name} phase-3 lanes, chunked (q_chunk 16 "
                "and 4) vs ragged kernel: "
                + ("bitwise equal" if same else
                   f"NOT bitwise equal, max_abs_diff {diff:.3e}"))
            diffs.append(diff)
    return max(errs), max(diffs)


def decode_check(torch, np, api, dev):
    """Phase 13; returns the largest error against the plain version.  The
    decode kernel on DECODE_CASE (sorted and shuffled BlockList) and on the
    long-context cases (owners of 1 to 3999 keys, 1 to 16 splits, at
    smollm-360m's and Fig 17's widths): against paged_attention_opt (f32
    atol 2e-5; bf16 atol 2e-2 and the per-element limit, which the 8-ulp
    control must fail), a second call the same bits, and the chunked and
    ragged kernels on the same lanes the same bits."""
    from repro_torch.core.paged_kv import fused_kv_views
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, CHUNKED_ARG_ORDER, DECODE_ARG_ORDER, LONG_DECODE,
        LONG_WIDTHS, decode_case, decode_lanes)

    cases = [(f"{'shuffled' if shuffle else 'sorted'} BlockList",
              dict(FULL_WIDTHS, **DECODE_CASE, shuffle=shuffle))
             for shuffle in (False, True)]
    cases += [(f"long-context, {name} widths",
               dict(LONG_WIDTHS[name], **LONG_DECODE))
              for name in sorted(LONG_WIDTHS)]
    errs = []
    for case_name, shape in cases:
        c = decode_case(np.random.default_rng(1), **shape)
        lanes = decode_lanes(c)
        empty = torch.from_numpy(c["seq_lens"] == 0).to(dev)
        for name, atol in DTYPES:
            dtype = getattr(torch, name)
            args = [torch.from_numpy(c[k]).to(dev) for k in DECODE_ARG_ORDER]
            args[:3] = [a.to(dtype) for a in args[:3]]
            ragged_args = [torch.from_numpy(lanes[k]).to(dev)
                           for k in ARG_ORDER]
            ragged_args[:2] = [a.to(dtype) for a in ragged_args[:2]]
            chunked_args = [ragged_args[0], *fused_kv_views(ragged_args[1]),
                            *[torch.from_numpy(lanes[k]).to(dev)
                              for k in CHUNKED_ARG_ORDER]]
            got = api.paged_attention_op(*args)
            again = api.paged_attention_op(*args)
            chunked = api.paged_attention_chunked_op(*chunked_args)
            ragged = api.paged_attention_ragged_op(*ragged_args)
            torch.cuda.synchronize()
            q = args[0]
            errs.append(compare(
                torch, got, api.paged_attention_opt(*args), atol,
                f"{case_name} {name} B={q.shape[0]} H={q.shape[1]} "
                f"hd={q.shape[2]} Tb={len(c['block_list'])} seq_lens "
                f"{c['seq_lens'].tolist()}"))
            if name == "bfloat16":
                share = api.chunked_bf16_share(got, *chunked_args)
                small = (got.float().abs() < 0.25).to(torch.int16)
                control = api.chunked_bf16_share(
                    (got.view(torch.int16) + 8 * small).view(torch.bfloat16),
                    *chunked_args)
                log(f"    on f32 q, k: largest |err| / (2^-7 (M + |want|) + "
                    f"1e-4) {share:.4f}; the 8-ulp control {control:.4f}")
                if not share <= 1 < control:
                    raise AssertionError(f"{case_name}: {share:.3f}x the "
                                         f"limit, control {control:.3f}x")
            if torch.any(got[empty] != 0):
                raise AssertionError("a request with no entry must read 0")
            for what, other in (("a second call", again),
                                ("the chunked kernel", chunked),
                                ("the ragged kernel", ragged)):
                if not torch.equal(got, other):
                    raise AssertionError(
                        f"{case_name} {name}: decode kernel vs {what}: not "
                        "bitwise equal, max_abs_diff "
                        f"{(got.float() - other.float()).abs().max():.3e}")
    log("  the request with no entry reads 0; decode == chunked == ragged on "
        "the same lanes, and two calls, bit for bit")
    return max(errs)


def split_counts(np, block_req, block_pos, owners, kvls, block_size):
    """'kvl:splits' of each decode-tile owner (one lane): the keys of its
    pages below its kvl (its compacted list) in splits of SPLIT_KEYS."""
    from repro_torch.core.attention_api import SPLIT_KEYS

    req = block_req.cpu().numpy()
    pos = block_pos.cpu().numpy().astype(np.int64)
    out = []
    for o, k in zip(owners, kvls):
        keys = int(((req == o) & (pos * block_size < k)).sum()) * block_size
        out.append(f"{int(k)}:{max(1, -(-keys // SPLIT_KEYS))}")
    return " ".join(out)


def ragged_splits(np, inputs):
    """split_counts of a ragged call's sequences of one lane."""
    _, pool, _, br, bp, cu_q, cu_kv, ss = inputs
    cu_q, cu_kv = cu_q.cpu().numpy(), cu_kv.cpu().numpy()
    one = [j for j in range(len(cu_q) - 1) if cu_q[j + 1] - cu_q[j] == 1]
    return split_counts(np, br, bp, ss.cpu().numpy()[one],
                        [cu_kv[j + 1] - cu_kv[j] for j in one], pool.shape[1])


def decode_splits(np, inputs):
    """split_counts of a decode call's requests."""
    _, pk, _, _, br, bp, seq_lens = inputs
    lens = seq_lens.cpu().numpy()
    return split_counts(np, br, bp, range(len(lens)), lens, pk.shape[1])


def chunked_splits(np, inputs):
    """split_counts of a chunked call's owners of one lane."""
    _, pk, _, _, br, bp, kv_lens, treq, _ = inputs
    kvl = kv_lens.cpu().numpy()
    owners, lanes = np.unique(treq.cpu().numpy(), return_counts=True)
    one = [o for o, n in zip(owners, lanes) if n == 1 and 0 <= o < len(kvl)]
    return split_counts(np, br, bp, one, [kvl[o] for o in one], pk.shape[1])


def serve_chunked(torch, np, cfg_mod, engine_mod, api, counted, model,
                  params, cfg, prompts, served, dev):
    """Phase 15: phase 5's requests through attn_impl="chunked"; returns
    the chunked kernel's launches and the captured layer-0 inputs."""
    def engine(attn_impl, num_blocks):
        serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                    max_batch=SERVE_BATCH,
                                    attn_impl=attn_impl)
        return engine_mod.ServingEngine(model, params, cfg, serve,
                                        num_blocks=num_blocks, device=dev)

    def run(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, p in prompts:
            eng.submit(engine_mod.Request(req_id=i, prompt=p,
                                          max_new_tokens=SERVE_NEW))
        eng.run_until_done()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    warm = engine("chunked", 256)
    for i, p in prompts[:2]:
        warm.submit(engine_mod.Request(req_id=i, prompt=p[:64],
                                       max_new_tokens=4))
    warm.run_until_done()
    del warm
    chunked = engine("chunked", SERVE_BLOCKS)
    op = api.paged_attention_chunked_op         # holds the launch count
    capture = Capture(api, "paged_attention_chunked_op", chunked)
    reset_counts(counted)
    wall = run(chunked)
    launches = op.launches
    ragged = counted[0].launches
    capture.close()
    m = chunked.metrics()
    log(f"  steps {m['steps']}  output tokens {m['output_tokens']}  wall "
        f"{wall:.3f}s  output tok/s {m['output_tokens'] / wall:.1f}")
    log(f"  TTFT p50 {m['p50_ttft_s'] * 1e3:.1f} / p99 "
        f"{m['p99_ttft_s'] * 1e3:.1f} ms  TPOT p50 "
        f"{m['p50_tpot_s'] * 1e3:.2f} / p99 {m['p99_tpot_s'] * 1e3:.2f} ms  "
        f"attn_impl {m['attn_impl']} q_chunk {m['q_chunk']}")
    log(f"  chunked kernel launches {launches} = steps x layers "
        f"{m['steps']} x {cfg.num_layers}; ragged launches {ragged}")
    log(f"  steps by kind: {capture.by_kind()}")
    if launches != m["steps"] * cfg.num_layers or launches == 0 or ragged:
        raise AssertionError(f"chunked launches {launches} != steps x "
                             f"layers, or ragged launches {ragged} != 0")
    streams = {r.req_id: list(r.output) for r in chunked.finished}
    if streams != served:
        diff = [i for i in served if streams.get(i) != served[i]]
        raise AssertionError(f"chunked greedy streams differ from phase "
                             f"5's ragged run for requests {diff}")
    log(f"  greedy streams identical to phase 5's ragged run "
        f"({len(streams)} requests x {SERVE_NEW} tokens)")
    chunked.alloc.check_invariants(drained=True)
    log("  allocator invariants hold; pool drained")
    for kind in ("mixed", "decode"):
        if kind not in capture.got:
            raise AssertionError(f"no {kind} step captured")
    capture.got["by_kind"] = (capture.steps, capture.launches)
    del chunked
    # the same workload again, ragged and chunked in turns, for TPOT: the
    # step is host-bound and hosts drift, so only neighbours compare
    for attn_impl in ("ragged", "chunked", "chunked", "ragged"):
        eng = engine(attn_impl, SERVE_BLOCKS)
        wall = run(eng)
        m = eng.metrics()
        log(f"  in turns, {attn_impl:7s}: wall {wall:.3f}s  TPOT p50 "
            f"{m['p50_tpot_s'] * 1e3:.2f} / p99 "
            f"{m['p99_tpot_s'] * 1e3:.2f} ms  TTFT p50 "
            f"{m['p50_ttft_s'] * 1e3:.1f} ms")
        del eng
    return launches, capture.got


def paper_path(torch, np, api, counted, model, params, cfg, dev):
    """Phase 16: decode_step_paged over split pools; returns the decode
    kernel's launches and the last step's captured layer-0 inputs."""
    from repro_torch.core.paged_kv import BlockAllocator, make_pool

    B, BS, a = SERVE_BATCH, SERVE_BS, cfg.attention
    steps = PAPER_PROMPT + PAPER_NEW - 1   # the last token is not fed back
    nb = B * -(-steps // BS)
    pk, pv = make_pool(cfg.num_layers, nb, BS, a.num_kv_heads, a.head_dim,
                       model.dtype, dev)
    pools = {"k": pk, "v": pv}
    alloc = BlockAllocator(num_blocks=nb, block_size=BS)
    for r in range(B):
        alloc.allocate(r, 0)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, PAPER_PROMPT), dtype=np.int32)).to(dev)
    op = api.paged_attention_op                 # holds the launch count
    capture = Capture(api, "paged_attention_op")
    generated = []
    tok = prompt[:, 0]
    torch.cuda.synchronize()
    reset_counts(counted)
    t0 = time.perf_counter()
    for t in range(steps):
        if t == steps - 1:
            capture.arm("decode")
        lists = step_lists(torch, alloc, B, nb, dev)
        logits, pools = model.decode_step_paged(params, pools, lists, tok,
                                                num_lanes=B)
        for r in range(B):
            alloc.commit_token(r)
        if t + 1 < PAPER_PROMPT:
            tok = prompt[:, t + 1]
        else:
            tok = logits.argmax(dim=-1).to(torch.int32)
            generated.append(tok)
        if t + 1 == PAPER_PROMPT:
            torch.cuda.synchronize()
            t_prompt = time.perf_counter()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = op.launches
    capture.close()
    out = torch.stack(generated, 1).cpu()
    log(f"  {steps} steps: {1e3 * (t_end - t0) / steps:.2f} ms/step; prompt "
        f"steps {1e3 * (t_prompt - t0) / PAPER_PROMPT:.2f} ms/step, greedy "
        f"steps {1e3 * (t_end - t_prompt) / (steps - PAPER_PROMPT):.2f} "
        f"ms/step (host clock, synchronised)")
    log(f"  decode kernel launches {launches} = steps x layers {steps} x "
        f"{cfg.num_layers}; {nb}-block split pools, BlockList of {nb}")
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"decode launches {launches} != steps x layers")
    if out.shape != (B, PAPER_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"bad greedy tokens {tuple(out.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    log(f"  {B} x {PAPER_NEW} greedy tokens in range, logits finite")
    if "decode" not in capture.got:
        raise AssertionError("no decode step captured")
    return launches, capture.got


def fig17(torch, dev, card):
    """Phase 17: the Fig 17 benchmark at the reference's full sizes."""
    from repro_torch.bench import paged_attention_bench as bench

    t0 = time.perf_counter()
    rows = bench.run(dev)
    log(f"  Fig 17 benchmark {time.perf_counter() - t0:.1f}s  [{card}]")
    if any(r.get("kernel_ms", 0) is None for r in rows):
        raise AssertionError("a decode kernel time is missing")
    for r in rows:
        if "frac" in r:
            log(f"  pad {r['frac']:.0%}: base {r['base_ms']:.4f} ms  "
                f"opt-plain {r['opt_ms']:.4f} ms  opt-kernel "
                f"{r['kernel_ms']:.4f} ms  bytes ratio "
                f"{r['bytes_ratio']:.2f}  opt-kernel speedup over base "
                f"{r['base_ms'] / r['kernel_ms']:.2f}x")
        elif "batch" in r:
            log(f"  B={r['batch']} S={r['seq']}: base {r['base_ms']:.4f} ms"
                f"  opt-plain {r['opt_ms']:.4f} ms  opt-kernel "
                f"{r['kernel_ms']:.4f} ms")
        elif "chunk" in r:
            log(f"  chunked C={r['chunk']} ({r['tokens']} tokens): kernel "
                f"{r['ms']:.4f} ms = {r['us_per_token']:.3f} us/token;"
                f" plain {r['plain_ms']:.4f} ms")
        elif "us_fused" in r:
            log(f"  {r['name']}: ragged {r['us_fused']:.1f} us, chunked "
                f"{r['us_split']:.1f} us, bitwise {r['bitwise']} "
                f"(max_abs_diff {r['max_abs_diff']:.3e})")


def kernel_times(torch, op, inputs, kw, out_run, bound, what, card,
                 share=None):
    """The kernel behind ``op`` on captured inputs: rerun (deterministic,
    finite), against its plain version (bf16, atol 2e-2, and the
    per-element limit ``share`` where given), and its time and TFLOP/s
    beside the plain version's and both bounds (:func:`bounds`)."""
    again = op(*inputs, **kw)
    torch.cuda.synchronize()
    if not torch.equal(again, out_run):
        raise AssertionError(f"{what}: kernel is not deterministic")
    if not torch.isfinite(again).all():
        raise AssertionError(f"{what}: non-finite attention output")
    err = compare(torch, again, op.plain(*inputs, **kw), 2e-2, f"bf16 {what}")
    limit = None
    if share is not None:
        limit = share(again, *inputs, **kw)
        log(f"    on f32 q, k: largest |err| / (2^-7 (M + |want|) + 1e-4) "
            f"{limit:.4f}")
        if not limit <= 1:
            raise AssertionError(f"{what}: kernel disagrees with the plain "
                                 f"version on f32 q, k by {limit:.3f}x the "
                                 "limit")
    ms = kernel_ms(op, *inputs, device="cuda", reps=50, **kw)
    plain_ms = device_ms(lambda: op.plain(*inputs, **kw), device="cuda",
                         reps=3)
    tflops = bound["ops"] / ms / 1e9
    log(f"  {what}: kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s)  plain "
        f"{plain_ms:.3f} ms  bounds: bytes {bound['bytes_ms']:.4f} ms, "
        f"operations {bound['ops_ms']:.4f} ms -> {bound['bound_ms'] / ms:.1%}"
        f" of the larger ({bound['bound_by']})  [{card}]")
    by_kernel = launch_device_ms(torch, op, inputs, kw)
    log("    device time per call under the profiler: " + ", ".join(
        f"{name} {t:.4f} ms" for name, t in by_kernel.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                bytes_ms=bound["bytes_ms"], ops_ms=bound["ops_ms"],
                tflops=tflops, bf16_share=limit, profiled_ms=by_kernel)


def launch_device_ms(torch, op, inputs, kw, n=20):
    """Device ms per call of each kernel a launch of ``op`` runs (its list
    kernels and its attention kernel), from torch.profiler over ``n``
    launches through the C entry point: what kernel_ms reads less the gaps
    between the kernels, and less the host's enqueue where that is slower
    than the card."""
    from torch.profiler import ProfilerActivity, profile

    launch = op.prepare(*inputs, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if launch.fn(*launch.argv) != 0:
                raise AssertionError(f"{op.name}: launch failed")
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        name = re.search(r"(\w+_kernel)", e.key)
        if us > 0 and name:
            out[name.group(1)] = us / n / 1e3
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from repro_torch import config as cfg_mod
    from repro_torch.core import attention_api as api
    from repro_torch.core import embedding_api as emb_api
    from repro_torch.kernels import batched_embedding as emb_kernel
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as flash_kernel
    from repro_torch.kernels import gather_scatter as gs_kernel
    from repro_torch.kernels import paged_attention as pa_kernel
    from repro_torch.kernels import stream as stream_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.gather_scatter import ops as gs_ops
    from repro_torch.kernels.stream import ops as stream_ops
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, ragged_case)
    from repro_torch.models.api import build_model
    from repro_torch.serving import engine as engine_mod

    # the launch counts, held here: a Capture replaces a module attribute
    counted = (api.paged_attention_ragged_op, api.paged_attention_chunked_op,
               api.paged_attention_op, emb_api.embedding_bag,
               *stream_ops.OPS, *gs_ops.OPS, flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card -------------------------------------------------------------
    log("== 1. card")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  "
        f"capability {torch.cuda.get_device_capability(0)}")

    # 2. build ----------------------------------------------------------------
    log("== 2. build")
    t0 = time.perf_counter()
    builds = build.build_all(SOURCES)
    for name, r in builds.items():
        log(f"  {name}: done {r['seconds']:.2f}s into the parallel build, "
            f"cache_hit={r['cache_hit']} "
            f"-> {build.library_path(name).relative_to(ROOT)}")
        for line in r["log"].splitlines():
            entry = re.search(r"Compiling entry function '_ZN\w+?_cu_"
                              r"[0-9a-f]+\d+(\w+?)E?v?P", line)
            if entry:
                log(f"    {entry.group(1)}:")
            elif "registers" in line or "spill" in line:
                log(f"      {line.strip()}")
    for source in (KERNEL, CHUNKED_KERNEL, DECODE_KERNEL):
        pa_kernel.library(source)
    emb_lib = emb_kernel.library()
    for kernel in (stream_kernel, gs_kernel, flash_kernel):
        kernel.library()
    log(f"  build (parallel) + load {time.perf_counter() - t0:.2f}s")

    # 3. kernel vs plain at full width ---------------------------------------
    log("== 3. kernel vs plain, smollm-360m widths and the long-owner cases, "
        "synthetic lanes")
    for name, shape in synthetic_cases():
        c = ragged_case(np.random.default_rng(0), **shape)
        for dtype, atol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            args = [torch.from_numpy(c[k]).to(dev) for k in ARG_ORDER]
            args[:2] = [a.to(dtype) for a in args[:2]]
            got = api.paged_attention_ragged_op(*args)
            torch.cuda.synchronize()
            q, bl, ss = args[0], args[2], args[7]
            compare(torch, got, api.paged_attention_ragged(*args), atol,
                    f"{name} {str(dtype)[6:]} T={q.shape[0]} H={q.shape[1]} "
                    f"hd={q.shape[2]} S={ss.shape[0]} Tb={bl.shape[0]}")
            if dtype == torch.bfloat16:
                share = api.ragged_bf16_share(got, *args)
                # the outputs under 0.25 moved by 8 ulps must fail the limit
                small = (got.float().abs() < 0.25).to(torch.int16)
                control = api.ragged_bf16_share(
                    (got.view(torch.int16) + 8 * small).view(torch.bfloat16),
                    *args)
                log(f"    on f32 q, k: largest |err| / (2^-7 (M + |want|) + "
                    f"1e-4) {share:.4f}; the control (outputs under 0.25 "
                    f"moved by 8 ulps) {control:.4f}")
                if not share <= 1 < control:
                    raise AssertionError(f"{name}: {share:.3f}x the limit, "
                                         f"control {control:.3f}x")
            if torch.any(got[int(c["cu_q_lens"][-1]):] != 0):
                raise AssertionError("padding lanes must read 0")

    # 4. small-input reference: card vs CPU -----------------------------------
    log("== 4. reduced smollm-360m f32: card vs CPU")
    ragged_streams = reference_check(torch, np, cfg_mod, build_model,
                                     engine_mod)

    # 5. serving at full width --------------------------------------------------
    log("== 5. serving smollm-360m (32 layers, bf16, random weights)")
    cfg = cfg_mod.get_config("smollm-360m")
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  params {n_params / 1e6:.1f}M  dtype {model.dtype}")
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                max_batch=SERVE_BATCH)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, (256,), dtype=np.int32)

    def requests(n, lo, hi, new):
        """n requests; every fourth opens with the same 256-token prefix."""
        out = []
        for i in range(n):
            length = int(rng.integers(lo, hi))
            p = rng.integers(0, cfg.vocab_size, (length,), dtype=np.int32)
            if i % 4 == 0 and length > 2 * len(shared):
                p[:len(shared)] = shared
            out.append(engine_mod.Request(req_id=i, prompt=p,
                                          max_new_tokens=new))
        return out

    warm = engine_mod.ServingEngine(model, params, cfg, serve,
                                    num_blocks=256, device=dev)
    for r in requests(2, 64, 65, 4):
        warm.submit(r)
    warm.run_until_done()
    del warm
    engine = engine_mod.ServingEngine(model, params, cfg, serve,
                                      num_blocks=SERVE_BLOCKS, device=dev)
    reqs = requests(16, 128, 1025, SERVE_NEW)
    log(f"  prompts: {sorted(len(r.prompt) for r in reqs)}")
    kernel_op = api.paged_attention_ragged_op    # holds the launch count
    capture = Capture(api, "paged_attention_ragged_op", engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counted)
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_op.launches
    capture.close()
    m = engine.metrics()
    log(f"  steps {m['steps']}  output tokens {m['output_tokens']}  wall "
        f"{wall:.3f}s  output tok/s {m['output_tokens'] / wall:.1f}  "
        f"lane tokens/step {m['lane_tokens_per_step']:.1f}")
    log(f"  TTFT p50 {m['p50_ttft_s'] * 1e3:.1f} / p99 "
        f"{m['p99_ttft_s'] * 1e3:.1f} ms  TPOT p50 "
        f"{m['p50_tpot_s'] * 1e3:.2f} / p99 {m['p99_tpot_s'] * 1e3:.2f} ms")
    log(f"  prefix hit rate {m['prefix_hit_rate']:.3f}  cow copies "
        f"{m['cow_copies']}  preemptions {m['preemptions']}  phases "
        + "  ".join(f"{k} {v:.3f}s" for k, v in sorted(m['phase_s'].items())))
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB;  kernel launches {launches} = steps x layers "
        f"{m['steps']} x {cfg.num_layers}")
    log(f"  steps by kind: {capture.by_kind()}")
    if launches != m["steps"] * cfg.num_layers or launches == 0:
        raise AssertionError(f"kernel launches {launches} != steps x layers")
    if m["finished"] != len(reqs):
        raise AssertionError(f"finished {m['finished']} of {len(reqs)}")
    for r in engine.finished:
        if len(r.output) != SERVE_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.req_id}: bad output {r.output}")
    engine.alloc.check_invariants(drained=True)
    log("  allocator invariants hold; pool drained "
        f"({engine.alloc.num_free}/{engine.alloc.num_blocks} blocks free)")
    for kind in ("mixed", "decode"):
        if kind not in capture.got:
            raise AssertionError(f"no {kind} step captured")
    served = {r.req_id: list(r.output) for r in engine.finished}
    prompts = [(r.req_id, r.prompt) for r in reqs]

    # 6. captured inputs: kernel vs plain, and times ---------------------------
    log("== 6. layer-0 inputs of real steps: kernel vs plain, times")
    steps = {}
    for kind in ("decode", "mixed"):
        inputs, kw, out_run = capture.got[kind]
        q, _, bl, _, _, cu_q, cu_kv, ss = inputs
        log(f"  {kind} step (nq, kvl) per sequence: "
            f"{lanes_by_sequence(cu_q, cu_kv)}")
        log(f"  {kind} step decode-tile sequences (one lane), kvl:splits "
            f"{ragged_splits(np, inputs)}")
        steps[kind] = kernel_times(
            torch, api.paged_attention_ragged_op, inputs, kw, out_run,
            ragged_bound(torch, inputs),
            f"{kind} step T={q.shape[0]} real lanes {int(cu_q[-1])} "
            f"S={ss.shape[0]} Tb={bl.shape[0]}", card,
            share=api.ragged_bf16_share)
        steps[kind].update(steps=capture.steps.get(kind, 0),
                           launches=capture.launches.get(kind, 0))
    ragged_inst = ptxas_instances(
        "ragged_attention_kernel",
        pa_kernel.library(KERNEL).paged_attention_ragged_smem_bytes,
        builds[KERNEL]["log"], build, card, paged_tile)
    # 7. where a decode step's and a mixed step's time goes -------------------
    log("== 7. profile of decode-only steps (16 requests, 512-token prompts)")
    profile_decode(torch, np, model, params, cfg, serve, engine_mod, dev)
    log("== 7b. profile of phase 5's first mixed step (phase 5's requests)")
    mixed_profile = profile_mixed(torch, model, params, cfg, serve,
                                  engine_mod, prompts, dev)

    del engine, capture
    torch.cuda.empty_cache()

    # 8. embedding kernel vs plain at full width -----------------------------
    log("== 8. embedding-bag kernel vs plain, rm1/rm2 full widths")
    emb_errs = [embedding_check(torch, cfg_mod.get_config(arch), emb_api, dev)
                for arch in ("rm1", "rm2")]

    # 9. small-input reference: card vs CPU -----------------------------------
    log("== 9. rm2 with 4096 rows per table, f32: card vs CPU")
    dlrm_reference_check(torch, cfg_mod, build_model, dev)

    # 10. DLRM inference at full width ------------------------------------------
    log("== 10. DLRM inference, rm1/rm2 at 1 M rows per table, f32")
    reset_counts(counted)
    emb_launches = dlrm_inference(torch, emb_api, dev)

    # 11. embedding kernel times at the main path's B = 4096 inputs -----------
    log(f"== 11. embedding-bag kernel times, B={EMB_BATCH}")
    emb = {arch: embedding_times(torch, cfg_mod.get_config(arch), build_model,
                                 emb_api, emb_lib, dev, card)
           for arch in ("rm1", "rm2")}
    emb_err = max([e["max_abs_err"] for e in emb.values()] + emb_errs)

    # 12. chunked kernel vs plain, and vs the ragged kernel --------------------
    log("== 12. chunked kernel vs plain, smollm-360m widths, synthetic lanes")
    chunked_err, ragged_diff = chunked_check(torch, np, api, ragged_case,
                                             dev)

    # 13. decode kernel vs plain ------------------------------------------------
    log("== 13. decode kernel vs paged_attention_opt, smollm-360m widths")
    decode_err = decode_check(torch, np, api, dev)

    # 14. small-input reference: card vs CPU -----------------------------------
    log("== 14. reduced smollm-360m f32: chunked engine and decode_step_paged,"
        " card vs CPU")
    chunked_streams = reference_check(torch, np, cfg_mod, build_model,
                                      engine_mod, attn_impl="chunked")
    if chunked_streams != ragged_streams:
        raise AssertionError("chunked greedy streams differ from ragged: "
                             f"{chunked_streams} != {ragged_streams}")
    log("  chunked streams identical to phase 4's ragged streams")
    paper_reference_check(torch, np, cfg_mod, build_model, dev)

    # 15. serving with attn_impl="chunked" at full width ------------------------
    log("== 15. serving smollm-360m with attn_impl='chunked' (phase 5's "
        "requests)")
    c_launches, c_capture = serve_chunked(
        torch, np, cfg_mod, engine_mod, api, counted, model, params, cfg,
        prompts, served, dev)

    # 16. the paper path at full width -------------------------------------------
    log(f"== 16. decode_step_paged at full width: 16 requests, "
        f"{PAPER_PROMPT} prompt tokens one per step, {PAPER_NEW} greedy")
    d_launches, d_capture = paper_path(torch, np, api, counted, model, params,
                                       cfg, dev)
    del model, params
    torch.cuda.empty_cache()

    # 17. Fig 17 benchmark at the reference's full sizes -----------------------
    log("== 17. bench.paged_attention_bench (paper Fig 17 a-c), full sizes")
    fig17(torch, dev, card)

    # 18. new kernels' times on the captured inputs ----------------------------
    log("== 18. chunked and decode kernels on the captured layer-0 inputs")
    chunked_steps = {}
    c_steps, c_by_kind = c_capture["by_kind"]
    for kind in ("decode", "mixed"):
        inputs, kw, out_run = c_capture[kind]
        log(f"  chunked {kind} step decode-tile owners (one lane), "
            f"kvl:splits {chunked_splits(np, inputs)}")
        chunked_steps[kind] = kernel_times(
            torch, api.paged_attention_chunked_op, inputs, kw, out_run,
            chunked_bound(torch, inputs),
            f"chunked {kind} step T={inputs[0].shape[0]} "
            f"B={inputs[6].shape[0]} Tb={inputs[3].shape[0]} "
            f"q_chunk={kw.get('q_chunk', 16)}", card,
            share=lambda got, *a, **kw: api.chunked_bf16_share(got, *a))
        chunked_steps[kind].update(steps=c_steps.get(kind, 0),
                                   launches=c_by_kind.get(kind, 0))
    chunked_inst = ptxas_instances(
        "chunked_attention_kernel",
        pa_kernel.library(CHUNKED_KERNEL).paged_attention_chunked_smem_bytes,
        builds[CHUNKED_KERNEL]["log"], build, card, paged_tile)
    inputs, kw, out_run = d_capture["decode"]
    log(f"  decode_step_paged last step, kvl:splits per request "
        f"{decode_splits(np, inputs)}")
    decode_top = kernel_times(
        torch, api.paged_attention_op, inputs, kw, out_run,
        decode_bound(torch, inputs),
        f"decode_step_paged last step B={inputs[0].shape[0]} "
        f"Tb={inputs[3].shape[0]}", card)
    G = inputs[0].shape[1] // inputs[1].shape[2]
    decode_lib = pa_kernel.library(DECODE_KERNEL)
    decode_inst = ptxas_instances(
        "decode_attention_kernel",
        lambda hd, dt: decode_lib.paged_attention_decode_smem_bytes(hd, dt, G),
        builds[DECODE_KERNEL]["log"], build, card,
        lambda dtype, hd: "decode tile")

    del c_capture, d_capture
    torch.cuda.empty_cache()

    # 19. STREAM kernels vs plain ------------------------------------------------
    log("== 19. STREAM kernels vs plain, bitwise")
    stream_check(torch, stream_ops, dev)

    # 20. gather/scatter kernels vs plain -----------------------------------------
    log(f"== 20. gather/scatter kernels vs plain, bitwise, R={FIG9_R} "
        f"N={FIG9_N}")
    gs_check(torch, gs_ops, dev)

    # 21. flash-attention kernel vs plain ------------------------------------------
    log("== 21. flash-attention kernel vs plain")
    flash_err = flash_check(torch, flash_attention, dev)

    # 22. the microbenchmark path ------------------------------------------------
    log("== 22. bench.run --only stream,gather_scatter,gemm_roofline --full; "
        "STREAM at n = 2^28")
    reset_counts(counted)
    micro = microbench_path(torch, stream_ops, gs_ops, dev, card)

    # 23. the flash-attention op path ---------------------------------------------
    log("== 23. the flash_attention op at phase 21's shapes")
    reset_counts(counted)
    flash_inputs = flash_path(torch, flash_attention, dev)

    # 24. times of the new kernels ---------------------------------------------------
    log("== 24. STREAM, gather/scatter and flash-attention kernel times")
    stream_t = stream_times(torch, stream_ops, builds[STREAM_KERNEL]["log"],
                            build, dev, card)
    gs_t = gs_times(torch, gs_ops, builds[GS_KERNEL]["log"], build, dev,
                    card)
    flash_t = flash_times(torch, flash_attention, flash_inputs, card)
    flash_inst = flash_ptxas(flash_kernel, builds[FLASH_KERNEL]["log"],
                             build, card)

    ragged_top = dict(steps["mixed"], max_abs_err=max(
        s["max_abs_err"] for s in steps.values()))
    chunked_top = dict(chunked_steps["mixed"], max_abs_err=max(
        [s["max_abs_err"] for s in chunked_steps.values()] + [chunked_err]))
    for top in (ragged_top, chunked_top):
        del top["steps"], top["launches"]
    log(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{KERNEL}.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:471",
        "launches": launches, **ragged_top, "library_ms": None,
        "tile": PAGED_TILE, "decode": steps["decode"],
        "mixed": steps["mixed"], "mixed_step_profile": mixed_profile,
        "instances": ragged_inst}, {
        "name": CHUNKED_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{CHUNKED_KERNEL}.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:293",
        "launches": c_launches, **chunked_top, "library_ms": None,
        "max_abs_diff_vs_ragged": ragged_diff, "tile": PAGED_TILE,
        "decode": chunked_steps["decode"], "mixed": chunked_steps["mixed"],
        "instances": chunked_inst}, {
        "name": DECODE_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{DECODE_KERNEL}.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
        "launches": d_launches, **dict(decode_top, max_abs_err=max(
            decode_top["max_abs_err"], decode_err)),
        "library_ms": None, "tile": DECODE_TILE,
        "instances": decode_inst}, {
        "name": EMB_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{EMB_KERNEL}.cu",
        "replaces": "src/repro/kernels/batched_embedding/kernel.py:41",
        "launches": emb_launches, **emb["rm2"], "max_abs_err": emb_err,
        "rm1": emb["rm1"], "rm2": emb["rm2"]}, {
        "name": STREAM_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{STREAM_KERNEL}.cu",
        "replaces": "src/repro/kernels/stream/kernel.py:34",
        "launches": micro["stream"], **stream_t["float32"]["triad"],
        "launches_by_op": micro["stream_by_op"],
        **stream_t["float32"], "bf16": stream_t["bfloat16"],
        "instances": stream_t["instances"]}, {
        "name": GS_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{GS_KERNEL}.cu",
        "replaces": "src/repro/kernels/gather_scatter/kernel.py:28",
        "also_replaces": "src/repro/kernels/gather_scatter/kernel.py:48",
        "launches": micro["gather_scatter"], **gs_t["sweep"],
        "launches_by_op": micro["gather_scatter_by_op"],
        "rows": gs_t["rows"], "profile": gs_t["profile"],
        "instances": gs_t["instances"]}, {
        "name": FLASH_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{FLASH_KERNEL}.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:66",
        "launches": flash_inputs["launches"],
        **dict(flash_t["smollm-360m prefill"], max_abs_err=flash_err),
        "fig17": flash_t["Fig 17 widths"], "instances": flash_inst}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_decode(torch, np, model, params, cfg, serve, engine_mod, dev):
    """torch.profiler over three decode-only engine steps: device time by
    kernel, and the device's busy share of the steps' wall time."""
    eng = engine_mod.ServingEngine(model, params, cfg, serve, num_blocks=1024,
                                   device=dev)
    rng = np.random.default_rng(1)
    for i in range(SERVE_BATCH):
        eng.submit(engine_mod.Request(
            req_id=i, prompt=rng.integers(0, cfg.vocab_size, (512,),
                                          dtype=np.int32),
            max_new_tokens=16))
    while any(r.state.name != "DECODING" for r in eng.active.values()) \
            or eng.waiting:
        eng.step()
    for _ in range(2):                           # warm decode steps
        eng.step()
    profile_calls(torch, eng.step, 3, "decode steps", "step")


def profile_calls(torch, fn, n, what, unit):
    """torch.profiler over ``n`` calls of ``fn``: wall time per call, the
    device's busy share of it, device time by kernel and host time by op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, host = [], []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            host.append((e.self_cpu_time_total, e.count, e.key))
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows)
    per = 1e3 * n                       # us in all -> ms per call
    log(f"  {n} {what}: wall {wall_us / per:.3f} ms/{unit} under the "
        f"profiler; device busy {busy / per:.3f} ms/{unit} "
        f"({busy / wall_us:.1%} of wall)" if busy else
        "  device time: not measured (the profiler saw no device activity)")
    log("  device time by kernel:")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"    {dev_us / per:9.4f} ms/{unit}  {count // n:5d} calls/{unit}"
            f"  {key[:90]}")
    log("  host time by op (self CPU, profiler on):")
    for cpu_us, count, key in sorted(host, reverse=True)[:10]:
        log(f"    {cpu_us / per:9.4f} ms/{unit}  {count // n:5d} calls/{unit}"
            f"  {key[:90]}")
    launches = sum(count for _, count, key in host
                   if key == "cudaLaunchKernel") / n
    log(f"  cudaLaunchKernel calls per {unit}: {launches:.0f}")
    return dict(wall_ms=wall_us / per, busy_ms=busy / per,
                busy_share=busy / wall_us, launches=launches,
                device_ms={key: dev_us / per for dev_us, _, key in rows})


def profile_mixed(torch, model, params, cfg, serve, engine_mod, prompts,
                  dev):
    """torch.profiler over the first mixed step of phase 5's requests: wall,
    the device's busy share, and the attention kernel's device ms."""
    eng = engine_mod.ServingEngine(model, params, cfg, serve,
                                   num_blocks=SERVE_BLOCKS, device=dev)
    for i, p in prompts:
        eng.submit(engine_mod.Request(req_id=i, prompt=p,
                                      max_new_tokens=SERVE_NEW))
    kinds = []
    render = eng._render

    def spy(plan):
        kinds.append("mixed" if plan.decode and plan.prefill else
                     "decode" if plan.decode else "prefill")
        return render(plan)

    eng._render = spy
    while not any(r.state.name == "DECODING" for r in eng.active.values()):
        eng.step()
    # decode lanes beside prompts still waiting: the next step is mixed
    before = len(kinds)
    out = profile_calls(torch, eng.step, 1, "mixed step", "step")
    if kinds[before:] != ["mixed"]:
        raise AssertionError(f"the profiled step was {kinds[before:]}, not "
                             "mixed")
    attn = {k: v for k, v in out["device_ms"].items()
            if "attention_kernel" in k}
    for key, ms in attn.items():
        log(f"  attention kernel {ms:.4f} ms/step of device time: "
            f"{key[:70]}")
    out["attention_ms"] = sum(attn.values())
    del out["device_ms"]
    return out


def embedding_check(torch, cfg, emb_api, dev):
    """The embedding kernel against its plain version on the config's whole
    table (T x 1 M rows): uniform ids, ids in the last table's top 1000
    rows (64-bit offsets), global id -1 (wraps to the last row) and one id
    past the end (a NaN bag).  float32 and bfloat16; returns the largest
    error."""
    T, R, D, L = (cfg.num_tables, cfg.num_embeddings, cfg.embedding_dim,
                  cfg.gathers_per_table)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    table = torch.randn((T * R, D), generator=gen, device=dev).mul_(D ** -0.5)
    offs = torch.arange(T, dtype=torch.int32, device=dev) * R
    idx = torch.randint(0, R, (EMB_BATCH, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:64, T - 1] = torch.randint(R - 1000, R, (64, L), generator=gen,
                                    device=dev, dtype=torch.int32)
    idx[64, 0, 0] = -1                 # global -1: the table's last row
    idx[65, T - 1, L - 1] = R          # global T*R: past the end
    errs = []
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        t = table.to(dtype)
        got = emb_api.embedding_bag(t, offs, idx)
        torch.cuda.synchronize()
        want = emb_api.batched_table_lookup(t, offs, idx)
        nan = torch.isnan(got).any(dim=-1)
        if not torch.equal(nan, torch.isnan(want).any(dim=-1)) or \
                nan.nonzero().tolist() != [[65, T - 1]]:
            raise AssertionError(f"{cfg.name}: NaN bags "
                                 f"{nan.nonzero().tolist()} != [[65, {T - 1}]]")
        gib = t.numel() * t.element_size() / 2 ** 30
        errs.append(compare(torch, got[~nan], want[~nan], atol,
                            f"{cfg.name} {str(dtype)[6:]} table {T * R}x{D} "
                            f"({gib:.2f} GiB) bags {EMB_BATCH}x{T} L={L}"))
        del t, got, want
    log(f"  {cfg.name}: the bag past the end is NaN, the wrapped id agrees")
    return max(errs)


def dlrm_reference_check(torch, cfg_mod, build_model, dev):
    """rm2 at 4096 rows per table in float32: one forward of 256 samples on
    the card and on the CPU from the same weights and batch, BatchedTable
    and SingleTable."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticRecSysDataset

    cfg = dataclasses.replace(cfg_mod.get_config("rm2"), num_embeddings=4096)
    params_cpu = build_model(cfg, device="cpu").init(0)
    batch = SyntheticRecSysDataset(cfg, 256).batch_at(0)
    for use_batched in (True, False):
        logits = {}
        for d in ("cpu", dev):
            model = build_model(cfg, device=d, use_batched=use_batched)
            logits[str(d)] = model.forward(
                to_device(params_cpu, d),
                {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            ).cpu()
        compare(torch, logits[str(dev)], logits["cpu"], 1e-4,
                f"rm2 4096 rows use_batched={use_batched}: logits card vs CPU")


def dlrm_inference(torch, emb_api, dev):
    """The recsys_e2e sweep at full width; returns the embedding kernel's
    launch count over it, which must equal the BatchedTable forwards."""
    from repro_torch.bench import recsys_e2e

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = recsys_e2e.run(dev)
    torch.cuda.synchronize()
    launches = emb_api.embedding_bag.launches
    wall = time.perf_counter() - t0
    forwards = sum(r["calls"] for r in rows if r["use_batched"])
    log(f"  sweep wall {wall:.2f}s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches {launches} = BatchedTable forwards {forwards}")
    ms = {(r["arch"], r["batch"], r["use_batched"]): r["ms"] for r in rows}
    for arch, batch, _ in sorted(k for k in ms if k[2]):
        single, batched = ms[arch, batch, False], ms[arch, batch, True]
        log(f"  {arch} B={batch:5d}: SingleTable {single:.4f} ms  "
            f"BatchedTable {batched:.4f} ms  speedup {single / batched:.2f}x")
    for r in rows:
        if not r["finite"] or r["shape"] != (r["batch"],):
            raise AssertionError(f"{r['name']}: logits {r['shape']}, "
                                 f"finite={r['finite']}")
    if launches != forwards or launches == 0:
        raise AssertionError(f"embedding kernel launches {launches} != "
                             f"BatchedTable forwards {forwards}")
    return launches


def embedding_times(torch, cfg, build_model, emb_api, emb_lib, dev, card):
    """Times of the embedding kernel on the main path's B = 4096 inputs (the
    same seeded weights and batch as phase 10): the kernel through its C
    entry point, the plain version, ``F.embedding_bag`` (the yardstick),
    and the bound; then a profile of the whole forward on those inputs."""
    import torch.nn.functional as F

    from repro_torch.data.pipeline import SyntheticRecSysDataset

    params = build_model(cfg, device=dev).init(0)
    table, offs = params["embedding"], params["table_offsets"]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticRecSysDataset(cfg, EMB_BATCH).batch_at(0).items()}
    idx = batch["indices"]
    B, T, L = idx.shape
    R, D = table.shape
    gids = (idx + offs[None, :, None]).reshape(-1)
    out = torch.empty((B * T, D), dtype=table.dtype, device=dev)
    argv = (table.data_ptr(), gids.data_ptr(), out.data_ptr(), B * T, L, D, R,
            0, torch.cuda.current_stream().cuda_stream)

    def launch():
        err = emb_lib.batched_embedding(*argv)
        if err != 0:
            raise RuntimeError(f"embedding kernel launch failed: {err}")

    ms = device_ms(launch, device="cuda", reps=100)
    want = emb_api.batched_table_lookup(table, offs, idx)
    err = compare(torch, out.view(B, T, D), want, 1e-5,
                  f"{cfg.name} f32 B={B} (main-path inputs)")
    plain_ms = device_ms(lambda: emb_api.batched_table_lookup(table, offs,
                                                              idx),
                         device="cuda", reps=5)
    bags = gids.view(-1, L)
    library = F.embedding_bag(bags, table, mode="sum")
    compare(torch, library.view(B, T, D), want, 1e-4,
            f"{cfg.name} F.embedding_bag (yardstick) vs plain")
    library_ms = device_ms(lambda: F.embedding_bag(bags, table, mode="sum"),
                           device="cuda")
    rows = torch.unique(gids).numel()
    elt = table.element_size()
    nbytes = rows * D * elt + 4 * gids.numel() + B * T * D * elt
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = B * T * L * D / PEAK_OPS[str(table.dtype)]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(f"  {cfg.name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"F.embedding_bag {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
        f"({rows} distinct rows of {gids.numel()}, {nbytes / 1e6:.1f} MB) "
        f"-> {bound_ms / ms:.1%} of bound  [{card}]")
    model = build_model(cfg, device=dev)
    model.forward(params, batch)
    profile_calls(torch, lambda: model.forward(params, batch), 5,
                  f"{cfg.name} BatchedTable forwards at B={EMB_BATCH}",
                  "forward")
    del params
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def bits(torch, t):
    """``t``'s bit pattern, so that NaNs compare too."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def same_bits(torch, got, want, what):
    """Raises unless ``got`` and ``want`` have the same bits; returns their
    max_abs_err, which is then 0."""
    if not torch.equal(bits(torch, got), bits(torch, want)):
        ok = ~(torch.isnan(got) | torch.isnan(want))
        err = (got[ok].float() - want[ok].float()).abs().max().item()
        raise AssertionError(f"{what}: kernel is not bitwise equal to the "
                             f"plain version (max_abs_err {err:.3e}, NaN "
                             f"rows may differ too)")
    return 0.0


def stream_check(torch, ops, dev):
    """Phase 19: every STREAM op and block_rows, bitwise; then the
    persistent grid's edges, where two calls must give the same bits."""
    from repro_torch.kernels import stream as kernel
    from repro_torch.kernels.stream.cases import edge_shapes

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for n, block_rows_list, scalar in ((STREAM_N[0], STREAM_BLOCK_ROWS, 0.1),
                                       (STREAM_N[1], (256,), 3.0)):
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            a = torch.randn(n, generator=gen, device=dev).to(dtype)
            b = torch.randn(n, generator=gen, device=dev).to(dtype)
            for block_rows in block_rows_list:
                for op, args in ((ops.stream_add, (a, b)),
                                 (ops.stream_scale, (a, scalar)),
                                 (ops.stream_triad, (a, b, scalar))):
                    got = op(*args, block_rows)
                    torch.cuda.synchronize()
                    same_bits(torch, got, op.plain(*args, block_rows),
                              f"{op.name} n={n} {name} block_rows="
                              f"{block_rows}")
            log(f"  n={n} {name}, block_rows {list(block_rows_list)}: ADD, "
                f"SCALE and TRIAD (s={scalar}) bitwise equal (max_abs_err "
                f"0)")
            del a, b
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        for code, op in enumerate(ops.OPS):
            p = kernel.plan(code, 128 * 1024, 8, int(name == "bfloat16"))
            for what, rows, block_rows in edge_shapes(
                    p["sms"] * p["blocks_per_sm"]):
                n = rows * ops.LANES
                a = torch.randn(n, generator=gen, device=dev).to(dtype)
                b = torch.randn(n, generator=gen, device=dev).to(dtype)
                args = ((a,) if op is ops.stream_scale else (a, b)) + (
                    () if op is ops.stream_add else (0.1,))
                first = op(*args, block_rows)
                second = op(*args, block_rows)
                torch.cuda.synchronize()
                tag = (f"{op.name} {name} {what} (n={n} block_rows="
                       f"{block_rows})")
                same_bits(torch, first, op.plain(*args, block_rows), tag)
                same_bits(torch, second, first, f"{tag}, second call")
        log(f"  {name}, the grid's edges ("
            + ", ".join(what for what, _, _ in edge_shapes(0))
            + "): ADD, SCALE and TRIAD bitwise equal, two calls the same "
            "bits")


def gs_check(torch, ops, dev):
    """Phase 20: gather and scatter at Fig 9's full sizes, bitwise, with
    ids that wrap, fall outside and repeat."""
    from repro_torch.kernels.gather_scatter import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    R, N = FIG9_R, FIG9_N
    edge = torch.tensor([-1, -R, R, -R - 1, 2 ** 31 - 1], dtype=torch.int32,
                        device=dev)
    for vb, name, ids in FIG9_ROWS:
        dtype = getattr(torch, name)
        D = vb // (4 if name == "float32" else 2)
        table = torch.randn((R, D), generator=gen, device=dev).to(dtype)
        src = torch.randn((N, D), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, R if ids == "uniform" else HEAVY_ROWS, (N,),
                            generator=gen, device=dev, dtype=torch.int32)
        idx[:5] = edge
        idx[-1] = idx[5]                    # a repeat the last draw wins
        repeats = N - torch.unique(idx[5:]).numel()
        got = ops.vector_gather(table, idx)
        torch.cuda.synchronize()
        same_bits(torch, got, ref.gather_ref(table, idx),
                  f"gather {vb} B {name}")
        nan = torch.isnan(got).all(dim=1).nonzero().view(-1).tolist()
        if nan != [2, 3, 4]:
            raise AssertionError(f"gather {vb} B: NaN rows {nan} != [2, 3, 4]")
        del got
        kernel = table.clone()
        if ops.vector_scatter_(kernel, idx, src) is not kernel:
            raise AssertionError("vector_scatter_ must return its table")
        torch.cuda.synchronize()
        plain = ref.scatter_ref_(table.clone(), idx, src)
        same_bits(torch, kernel, plain, f"scatter {vb} B {name}")
        if not torch.equal(kernel[idx[5].long()], src[-1]):
            raise AssertionError("the last write of a repeated id lost")
        gib = table.numel() * table.element_size() / 2 ** 30
        log(f"  {vb:5d} B {name:8s} rows, {ids:7s} ids, table {gib:.2f} "
            f"GiB: gather and scatter bitwise equal; {repeats} repeated "
            f"ids, 3 NaN rows, 3 dropped writes, 2 wrapped ids")
        del table, src, kernel, plain
        torch.cuda.empty_cache()


def flash_qkv(torch, dev, B, S, H, KV, hd, dtype, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dtype))
        for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def flash_check(torch, op, dev):
    """Phase 21; returns the largest error against the plain version."""
    from repro_torch.kernels.flash_attention.ref import bf16_share

    errs, shares, control = [], [], None
    for i, (name, B, S, H, KV, hd, dtype, _) in enumerate(FLASH_CHECK_SHAPES):
        q, k, v = flash_qkv(torch, dev, B, S, H, KV, hd, dtype, 10 + i)
        # the TPU tiles 64 and 512 where S takes them, else S twice
        t0, t1 = ((64, 512) if S % min(64, S) == 0 and S % min(512, S) == 0
                  else (S, S))
        for causal in (True, False):
            got = op(q, k, v, causal=causal, bq=t0, bk=t0)
            again = op(q, k, v, causal=causal, bq=t1, bk=t1)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: bq/bk or a second call "
                                     "changed the result")
            err, share = compare_flash(
                torch, got, q, k, v, causal, f"{name} B={B} S={S} H={H} "
                f"KV={KV} hd={hd} {dtype} causal={causal}")
            errs.append(err)
            if share is None:
                continue
            shares.append(share)
            if control is None:
                # a bf16 fault in small outputs: those under 0.25 moved by
                # 8 ulps, at most about 2e-2
                small = (got.float().abs() < 0.25).to(torch.int16)
                bad = (got.view(torch.int16) + 8 * small).view(torch.bfloat16)
                control = (
                    (bad.float() - op.plain(q, k, v, causal=causal).float()
                     ).abs().max().item(),
                    bf16_share(bad, q, k, v, causal))
                log(f"    control (outputs under 0.25 moved by 8 ulps): "
                    f"max_abs_err {control[0]:.3e}, share {control[1]:.4f}")
                if not control[1] > 1:
                    raise AssertionError("the bf16 limit lets the control "
                                         "through")
        del q, k, v, got, again
        torch.cuda.empty_cache()
    log(f"  bq/bk 64 (or S) and 512 give the same bits at every shape; bf16: "
        f"largest share of the limit {max(shares):.4f}, the control's "
        f"{control[1]:.4f} (max_abs_err {control[0]:.3e}), rejected")
    return max(errs)


def microbench_path(torch, stream_ops, gs_ops, dev, card):
    """Phase 22: the harness over the §3 modules at full sizes and STREAM
    at n = 2^28; returns the launch counts, which must equal the calls the
    rows made."""
    from repro_torch.bench import run, stream

    t0 = time.perf_counter()
    results = run.main(["--only", "stream,gather_scatter,gemm_roofline",
                        "--full"])
    rows = [r for res in results for r in res["rows"]]
    rows += stream.run(dev, quick=False, n=STREAM_N[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops = (*stream_ops.OPS, *gs_ops.OPS)
    counts = {op.name: op.launches for op in ops}
    calls = {op.name: sum(r["calls"] for r in rows if r.get("op") == op.name)
             for op in ops}
    log(f"  wall {wall:.1f}s; launches {counts}; calls made {calls}  "
        f"[{card}]")
    if counts != calls or not all(counts.values()):
        raise AssertionError(f"launches {counts} != calls {calls}")
    for r in rows:
        if "op" in r and r["launches"] != r["calls"]:
            raise AssertionError(f"{r['name']}: {r['launches']} launches "
                                 f"for {r['calls']} calls")
        if not r["derived"].startswith("predicted") and not (
                0 < r["ms"] < float("inf")):
            raise AssertionError(f"{r['name']}: bad time {r['ms']}")
    for r in rows:
        dev_ms = r.get("kernel_ms", r.get("device_ms"))
        if "op" in r and not (dev_ms and 0 < dev_ms < float("inf")):
            raise AssertionError(f"{r['name']}: no kernel time {dev_ms}")
        if r.get("op", "").startswith("stream"):
            if not r["in_l2"] and r["bytes"] < 4 * H100.l2_bytes:
                raise AssertionError(f"{r['name']} n={r['n']}: "
                                     f"{r['bytes']} B is neither in the L2 "
                                     "nor 4x it")
            where = ("in L2" if r["in_l2"] else
                     f"{r['bytes'] / dev_ms / 1e-3 / HBM_BYTES_PER_S:.1%} of "
                     "HBM")
            log(f"  Fig 8 {r['name']:18s} n={r['n']:9d} block_rows "
                f"{r['block_rows']:4d}: kernel {dev_ms:.4f} ms  "
                f"{r['bytes'] / dev_ms / 1e6:7.1f} GB/s  {where}; "
                f"{r['bytes'] / H100.l2_bytes:.2f}x the L2; wrapper "
                f"{r['ms']:.4f} ms/call")
        elif "vec_bytes" in r:
            log(f"  Fig 9 {r['name']:13s}: kernel {dev_ms:.4f} ms  "
                f"{r['bytes'] / dev_ms / 1e6:7.1f} useful GB/s  "
                f"{r['bytes'] / dev_ms / 1e-3 / HBM_BYTES_PER_S:.1%} of HBM;"
                f"  library {r['library']} {r['library_ms']} ms; wrapper "
                f"{r['ms']:.4f} ms/call")
        elif "shape" in r and r["name"].startswith("gemm"):
            log(f"  GEMM {r['name']:21s}: {dev_ms:.4f} ms  "
                f"{r['flops'] / dev_ms / 1e9:7.1f} TFLOP/s  roofline "
                f"{r['roofline_ms']:.4f} ms "
                f"({r['flops'] / dev_ms / 1e-3 / H100.peak_bf16:.1%} of "
                f"the bf16 peak); {r['ms']:.4f} ms per call")
    by = {op.name: op.launches for op in stream_ops.OPS}
    gs_by = {op.name: op.launches for op in gs_ops.OPS}
    return {"stream": sum(by.values()), "stream_by_op": by,
            "gather_scatter": sum(gs_by.values()),
            "gather_scatter_by_op": gs_by}


def flash_path(torch, op, dev):
    """Phase 23: the op once per shape; returns its launches and the
    inputs of the two full-width shapes."""
    keep, calls = {}, 0
    for i, (name, B, S, H, KV, hd, dtype, causal) in enumerate(FLASH_SHAPES):
        q, k, v = flash_qkv(torch, dev, B, S, H, KV, hd, dtype, 20 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = op(q, k, v, causal=causal)
        calls += 1
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if out.shape != q.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{name}: output {tuple(out.shape)} not "
                                 "finite or of q's shape")
        log(f"  {name}: {tuple(q.shape)} over {KV} kv heads, {dtype}, "
            f"causal={causal}: finite, {ms:.2f} ms (host clock, "
            "synchronised)")
        if i < 2:
            keep[name] = (q, k, v, causal)
    launches = op.launches
    log(f"  flash kernel launches {launches} = calls {calls}")
    if launches != calls:
        raise AssertionError(f"flash launches {launches} != calls {calls}")
    return {"launches": launches, "inputs": keep}


def stream_times(torch, ops, ptxas_log, build, dev, card):
    """Phase 24, STREAM at n = 2^28, block_rows 256, float32 and bfloat16:
    each op's kernel beside its plain version, its ``torch`` call and its
    byte bound, with the grid it launched; then every instance's
    registers, shared memory and spills (a spill fails the phase)."""
    from repro_torch.kernels import stream as kernel

    n, block_rows = STREAM_N[1], 256
    s = 3.0
    out = {}
    for name in ("float32", "bfloat16"):
        dtype = getattr(torch, name)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        a = torch.randn(n, generator=gen, device=dev).to(dtype)
        b = torch.randn(n, generator=gen, device=dev).to(dtype)
        elt = a.element_size()
        rows = {}
        for key, op, args, library, arrays, flops in (
                ("add", ops.stream_add, (a, b), lambda: torch.add(a, b),
                 3, n),
                ("scale", ops.stream_scale, (a, s), lambda: torch.mul(a, s),
                 2, n),
                ("triad", ops.stream_triad, (a, b, s),
                 lambda: torch.add(b, a, alpha=s), 3, 2 * n)):
            nbytes = arrays * elt * n
            err = same_bits(torch, op(*args, block_rows),
                            op.plain(*args, block_rows),
                            f"{op.name} n={n} {name}")
            ms = kernel_ms(op, *args, block_rows, device="cuda")
            plain_ms = device_ms(lambda: op.plain(*args, block_rows),
                                 device="cuda", reps=10)
            library_ms = device_ms(library, device="cuda")
            bound_ms, bound_by = roofline(nbytes, flops, dtype)
            plan = kernel.plan(ops.OPS.index(op), n, block_rows,
                               int(name == "bfloat16"))
            log(f"  {op.name} n=2^28 {name}: kernel {ms:.4f} ms "
                f"({nbytes / ms / 1e6:.1f} GB/s)  plain {plain_ms:.4f} ms  "
                f"library {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})  -> {bound_ms / ms:.1%} of bound; kernel / "
                f"library {ms / library_ms:.3f}x; grid {plan['grid']} = "
                f"{plan['sms']} SMs x {plan['blocks_per_sm']}, "
                f"{plan['units']} units of {plan['unit_bytes']} B, "
                f"{plan['queued']} from the work queue  [{card}]")
            rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms, grid=plan["grid"])
        out[name] = rows
        del a, b
        torch.cuda.empty_cache()
    out["instances"] = stream_ptxas(ptxas_log, build, card)
    return out


def stream_ptxas(ptxas_log, build, card):
    """Phase 24: registers, shared memory and spills of every
    ``stream_kernel`` instance in the build's ``-Xptxas -v`` log; a spill
    fails the phase."""
    instances = []
    for r in build.ptxas_report(ptxas_log):
        inst = re.search(r"stream_kernelI(\w+?)Li(\d)E", r["entry"])
        if inst is None:
            raise AssertionError(f"unknown entry {r['entry']}")
        what = (f"stream_kernel<{STREAM_DTYPES[inst.group(1)]}, "
                f"{STREAM_OPS[int(inst.group(2))]}>")
        log(f"  {what}: {r['registers']} registers, {r['smem']} B static "
            f"shared memory, spill stores {r['spill_stores']} B, loads "
            f"{r['spill_loads']} B, stack {r['stack']} B  [{card}]")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{what} spills")
        instances.append(dict(kernel=what, registers=r["registers"],
                              smem_static=r["smem"], stack=r["stack"]))
    if not instances:
        raise AssertionError("no stream_kernel instance in the ptxas log")
    return instances


def gs_times(torch, ops, ptxas_log, build, dev, card):
    """Phase 24, gather and scatter at Fig 9's full sizes, float32 (the
    inputs of ``bench.gather_scatter_turns.fig9_inputs``), beside both
    bounds and the yardsticks; then the launches of one call at 16 and
    2048 B (torch.profiler) and every instance's spills (a spill fails the
    phase)."""
    from repro_torch.bench import gather_scatter as bench
    from repro_torch.bench.gather_scatter_turns import (PROFILED_BYTES,
                                                        fig9_inputs,
                                                        launch_profile)

    R = FIG9_R
    rows, profile = {}, {}
    for vb, table, src, idx in fig9_inputs(torch, dev):
        yard = bench.yardsticks(table, idx, src)
        for key, op, args in (("gather", ops.vector_gather, (table, idx)),
                              ("scatter", ops.vector_scatter_,
                               (table, idx, src))):
            nbytes = bench.useful_bytes(key, idx, R, vb)
            sector_ms, _ = roofline(bench.sector_bytes(key, idx, R, vb), 0,
                                    torch.float32)
            fresh = (table.clone(), *args[1:])
            err = same_bits(torch, op(*fresh),
                            op.plain(table.clone(), *args[1:]),
                            f"{key} {vb} B (timed inputs)")
            del fresh
            ms = kernel_ms(op, *args, device="cuda")
            plain_ms = device_ms(lambda: op.plain(*args), device="cuda",
                                 reps=5)
            library_ms = (device_ms(yard[key], device="cuda")
                          if yard[key] is not None else None)
            copy_ms = (device_ms(yard["index_copy"], device="cuda")
                       if key == "scatter" else None)
            bound_ms, bound_by = roofline(nbytes, 0, torch.float32)
            library = ("index_select" if key == "gather"
                       else yard["scatter_name"])
            log(f"  {key:7s} {vb:5d} B: kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  library {library} "
                + (f"{library_ms:.4f} ms" if library_ms else "")
                + (f", index_copy_ (no last-write rule) {copy_ms:.4f} ms"
                   if copy_ms else "")
                + f"  bound {bound_ms:.4f} ms ({nbytes / 1e6:.0f} MB) -> "
                f"{bound_ms / ms:.1%}; sector bound {sector_ms:.4f} ms -> "
                f"{sector_ms / ms:.1%}  [{card}]")
            rows[f"{key}_{vb}B"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, sector_bound_ms=sector_ms,
                library_ms=library_ms, library=library,
                index_copy_ms=copy_ms)
            if vb in PROFILED_BYTES:
                profile[f"{key}_{vb}B"] = launch_profile(
                    torch, lambda: op(*args))
                log("    torch.profiler, device ms per launch (launches "
                    "recorded per call): " + ", ".join(
                        f"{name} {p['ms']:.4f} ({p['per_call']:g})"
                        for name, p in profile[f"{key}_{vb}B"].items())
                    + f"; the call back to back {ms:.4f}")
        del table, src, yard
    sweep = {k: sum(r[k] for r in rows.values())
             for k in ("ms", "plain_ms", "bound_ms", "sector_bound_ms")}
    libs = [r["library_ms"] for r in rows.values()]
    sweep["library_ms"] = None if None in libs else sum(libs)
    library = ("none for the scatter" if sweep["library_ms"] is None
               else f"{sweep['library_ms']:.4f} ms")
    log(f"  the whole sweep (12 calls): kernel {sweep['ms']:.4f} ms  plain "
        f"{sweep['plain_ms']:.4f} ms  library {library}  bound "
        f"{sweep['bound_ms']:.4f} ms  sector bound "
        f"{sweep['sector_bound_ms']:.4f} ms")
    return {"sweep": dict(sweep, bound_by="bytes", max_abs_err=max(
        r["max_abs_err"] for r in rows.values())), "rows": rows,
        "profile": profile, "instances": gs_ptxas(ptxas_log, build, card)}


def gs_ptxas(ptxas_log, build, card):
    """Phase 24: registers, stack and spills of every gather/scatter
    instance in the build's ``-Xptxas -v`` log; a spill fails the phase."""
    instances = []
    for r in build.ptxas_report(ptxas_log):
        name = re.search(r"(gather_kernel|scatter_kernel|winner_kernel)"
                         r"(I(\w+?)Li(\d+)ELi(\d+)E)?",
                         r["entry"])
        if name is None:
            raise AssertionError(f"unknown entry {r['entry']}")
        what = (name.group(1) if name.group(2) is None else
                f"{name.group(1)}<{GS_WORDS[name.group(3)]}, L "
                f"{name.group(4)}, Rg {name.group(5)}>")
        log(f"  {what}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, loads {r['spill_loads']} B, stack "
            f"{r['stack']} B  [{card}]")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{what} spills")
        instances.append(dict(kernel=what, registers=r["registers"],
                              stack=r["stack"]))
    if not instances:
        raise AssertionError("no gather/scatter instance in the ptxas log")
    return instances


def flash_times(torch, op, path, card):
    """Phase 24, flash attention on phase 23's full-width inputs, beside
    ``scaled_dot_product_attention`` on the same tensors (a yardstick)."""
    import torch.nn.functional as F

    out = {}
    for name, (q, k, v, causal) in path["inputs"].items():
        B, S, H, hd = q.shape
        got = op(q, k, v, causal=causal)
        err, _ = compare_flash(torch, got, q, k, v, causal,
                               f"{name} bf16 (timed inputs)")
        ms = kernel_ms(op, q, k, v, device="cuda", reps=5, causal=causal)
        plain_ms = device_ms(lambda: op.plain(q, k, v, causal=causal),
                             device="cuda", reps=3)

        def library():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        diff = (library().transpose(1, 2).float() - got.float()).abs().max()
        library_ms = device_ms(library, device="cuda", reps=10)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        flops = 4 * B * H * S * S * hd // (2 if causal else 1)
        bound_ms, bound_by = roofline(nbytes, flops, q.dtype)
        log(f"  {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)  "
            f"plain {plain_ms:.4f} ms  SDPA {library_ms:.4f} ms (max diff "
            f"from the kernel {diff:.3e})  bound {bound_ms:.4f} ms "
            f"({bound_by}) -> {bound_ms / ms:.1%} of bound; kernel / SDPA "
            f"{ms / library_ms:.2f}x  [{card}]")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, tflops=flops / ms / 1e9,
                         kernel_over_library=ms / library_ms)
    return out


def flash_ptxas(kernel, ptxas_log, build, card):
    """Phase 24: registers, shared memory and spills of every
    ``flash_kernel`` instance of ``kernel.library()``; a spill fails the
    phase."""
    return ptxas_instances(
        "flash_kernel", kernel.library().flash_attention_smem_bytes,
        ptxas_log, build, card, flash_tile)


def flash_tile(dtype, hd):
    return ("SIMT" if dtype == "float32" else
            "wgmma" if hd >= 64 else "mma.sync")


def paged_tile(dtype, hd):
    """The tiles a ragged or chunked instance holds: the SIMT tile (f32
    owners of two or more lanes, padding) and the decode tile (owners of
    one lane); in bf16 also the tensor-core tile (owners of two or more
    lanes)."""
    return ("SIMT + decode" if dtype == "float32" else
            "SIMT + decode + " + ("wgmma" if hd >= 64 else "mma.sync"))


def ptxas_instances(kernel, smem_bytes, ptxas_log, build, card, tile_of):
    """Registers, shared memory and spills of every instance of the
    ``__global__`` function ``kernel``, from the build's ``-Xptxas -v``
    log; ``smem_bytes(hd, dtype code)`` gives the dynamic shared memory.
    A spill fails the phase."""
    rows = [r for r in build.ptxas_report(ptxas_log)
            if f"{kernel}I" in r["entry"]]
    if not rows:
        raise AssertionError(f"no {kernel} instance in the ptxas log")
    out = []
    for r in rows:
        inst = re.search(kernel + r"I(\w+?)Li(\d+)E", r["entry"])
        dtype = "float32" if inst.group(1) == "f" else "bfloat16"
        hd = int(inst.group(2))
        tile = tile_of(dtype, hd)
        dynamic = smem_bytes(hd, int(dtype != "float32"))
        log(f"  {kernel}<{dtype}, {hd}> ({tile}): {r['registers']} "
            f"registers, {r['smem']} B static + {dynamic} B dynamic shared "
            f"memory, spill stores {r['spill_stores']} B, loads "
            f"{r['spill_loads']} B, stack {r['stack']} B  [{card}]")
        if r["spill_stores"] or r["spill_loads"]:
            raise AssertionError(f"{kernel}<{dtype}, {hd}> spills")
        out.append(dict(dtype=dtype, hd=hd, tile=tile,
                        registers=r["registers"], smem_static=r["smem"],
                        smem_dynamic=dynamic))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
