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
   holds one tree;
25. trace-replay parity: ``repro_torch.bench.trace_replay`` on reduced
   float32 smollm-360m with the reference's weights (the size of
   ``BENCH_009.json``), four scenarios x seven configurations, on the card
   and on the CPU (the plain path) in this process.  Every card row's
   counters and greedy streams must equal its CPU twin's; every row must
   equal its ``BENCH_009.json`` row field for field (``us_per_call``
   aside), except the rows ``REFERENCE_CAVEATS`` names (ROADMAP queue C),
   which are held to the CPU run; ``repro_torch.perf.gate`` must pass
   against ``BENCH_009.json`` with those rows from the CPU run; the ragged
   kernel's launches must equal the forward steps x 2 layers;
26. the sweep at full width: phase 5's smollm-360m (32 layers, bf16,
   seeded weights) through the four scenarios x seven configurations and
   ``draft-model`` on ``mixed``: per row the counters, wall ms, TTFT p50 /
   p99 on the replay's virtual clock (the arrivals are virtual), TPOT p50
   / p99 in seconds of the host clock and the spec accept rate.  The
   ``ngram``, ``overlap`` and ``draft-model`` rows' greedy streams must
   equal their ``fcfs`` twin's, the ``auto`` asserts of the reference
   hold, every pool drains with the allocator's invariants intact, and
   the ragged kernel's launches equal the forward steps x 32;
27. (a) phase 5's 16 requests with ``overlap=True``: the build half of
   every step runs under ``torch.cuda.set_sync_debug_mode("error")`` (a
   call that waits for the card fails the phase), the greedy streams must
   equal phase 5's, launches steps x 32; wall and TPOT beside phase 5's,
   then overlap off and on in turns, and phase 7's profile of three
   decode-only steps with overlap on; (b) the same requests with
   ``spec="ngram"``, ``spec_k`` 3, ragged then chunked: streams equal to
   phase 5's, launches steps x 32, the accept rate; (c) layer 0's inputs
   of one verify step (no prefill lanes; the engine gives each drafted
   lane an attention owner of its own, on the decode tile) of each kernel
   against its plain version (phase 3's bf16 limit) and its time beside
   both bounds, as phase 6; then B1 on the same lanes grouped as the
   reference renders them (a drafted request one owner of 1 + k lanes, on
   the tensor-core tile): its time, bounds and its largest difference
   from the per-lane output;
28. the paper's LLM, llama31-8b, at full width (32 layers, H 32, KV 8,
   hd 128, bf16, seeded weights on the card; the earlier phases' models
   freed first, the peak device memory after the weights printed): (a)
   phase 5's 16 requests through the ragged kernel (B1): launches steps x
   32, invariants, the pool drains; TTFT / TPOT p50 / p99, tok/s, steps
   by kind; layer 0's inputs of a mixed and a decode-only step held to
   the plain version (phase 3's bf16 limit) and timed beside both bounds,
   as phase 6; phase 7's profile of three decode-only steps (busy share,
   ``cudaLaunchKernel`` per step) beside smollm-360m's; (b) the same
   requests with ``attn_impl="chunked"`` (B2): streams equal to (a)'s,
   and B2 on its captured inputs; (c) the paper path (phase 16's
   workload) through the decode kernel (B3): ms per step beside phase
   16's, B3 on its last step against ``paged_attention_opt``;
29. the host KV tier at that width: [prompt, prompt, filler, prompt]
   (17-token prompts, 4-token blocks, ``tiered``, 8 host blocks) in a
   roomy and a starved (7-block) pool: the starved streams must equal the
   roomy run's, with demotes and promotes and no leak; then the reference
   benchmark's tier-pressure scenario (``repro_torch.bench.disagg``: 5
   prompts of 3 blocks of 8, an 11-block pool, 3 rounds, each prompt
   twice): ``lru`` without a host tier against ``tiered`` with 20 host
   blocks, whose hit rate must be higher; the mean device-to-host and
   host-to-device copy of one 1 MiB block;
30. disaggregated serving at that width: the reference's burst (16
   prompts of 1024 tokens, 32 new, max_batch 8, 512-token prefill
   chunks, 16-token blocks, each engine the reference's pool), mono
   against split (``decode_steps_per_step`` 4): both roles' pools drain
   with their invariants, every request is handed off, no staging id is
   left; TPOT / TTFT p50 / p99, the handoff p50, each role's steps.
   Split's bf16 streams must equal mono's or leave them only at a token
   where mono's top two logits lie within two bf16 ulps (recorded by a
   sampling hook that calls the original); the same burst in float32 at
   depth 4 must give identical streams;
31. the paged kernels' tunables (``core/attention_api.py``) against the
   plain version: B1 at decode splits of 64 / 128 / 256 / 512 keys
   crossed with 128 and 64 query rows a tensor-core tile (128 // G and
   64 // G lanes), B2 and B3 at each split, on phase 3's cases, phase 13's
   decode cases and the captured layer-0 steps of phases 6 and 28a (f32
   atol 2e-5; bf16 atol 2e-2 and phase 3's limit); at each split the tile
   heights and B2 give B1's bits, and B3 gives B1's and B2's on decode
   lanes (the captured decode-only steps too); ``vmem_limit_bytes`` at
   each kernel's request gives the uncapped bits, one byte below it a
   ValueError naming both sizes; no instance of the three kernels spills;
32. the autotune sweep (``bench.paged_attention_bench.autotune_sweep``) on
   the steps phases 6 and 28a captured, (16, 64, cuda) and (16, 128,
   cuda), each point's time (31 decode steps + 4 mixed steps) beside the
   default's; the committed ``src/repro_torch/perf/data/tune_h100.json``
   holds both cells with the defaults in each grid; an engine with every
   key at 0 resolves it (``tune.tuned_resolved`` 1); llama31-8b (kept
   from phase 28; its cell's winner is not the default) serves phase 5's
   workload with the resolved and with the default tunables in turns
   (TPOT, B1's decode / mixed ms of each), whose greedy streams are
   identical or part only at a top-2 gap of at most two bf16 ulps where
   the splits differ;
33. sanitized serving: the reference's sanitized smoke (reduced
   smollm-360m f32, overlap, ``tiered`` with 12 host / 7 HBM blocks) with
   zero retraces and trips and allowlisted host syncs; phase 5's workload
   at full width with overlap on, sanitized (streams equal phase 5's);
   controls: ``.item()`` inside ``no_host_sync`` and a host read of a
   reason off the allowlist must raise, and the sync debug mode must be
   restored;
34. MoE: reduced granite-moe-1b-a400m and qwen3-moe-235b-a22b in float32,
   card against CPU (one fused step's logits atol 1e-3, greedy streams
   identical); then granite-moe-1b-a400m at full width (24 layers, 32
   experts top-8 at full capacity, H 16 / KV 8 / hd 64, G 2, bf16, seeded
   weights): phase 5's requests through B1 (launches steps x 24, the pool
   drains) and B2 (streams equal B1's), the init peak, TTFT / TPOT, the
   profile of three decode-only steps, B1 / B2 on their layer-0 steps
   beside the plain version and the bounds, the MoE layer's device ms a
   step; then the paper path through B3;
35. the BatchedTable backward kernel (``batched_embedding_backward``)
   against its plain version (``batched_table_backward``) on phase 8's ids
   at RM1's and RM2's full widths (a wrapped id's row gets the gradient,
   an id past the end adds nothing): float32 atol 1e-5 (float atomics add
   in no fixed order, so never bitwise); then on the main path's B = 4096
   inputs its time (CUDA events over back-to-back launches through the C
   entry point) beside the plain version, ``F.embedding_bag(mode="sum")``'s
   backward (a yardstick, never used by the port), the bound (grad_out,
   the ids, a read and a write of each distinct row touched at 3.35 TB/s)
   and, on a line of its own, the dense gradient's zeroing (R x D x 4
   bytes); then every backward instance's registers and spills
   (``-Xptxas -v``; a spill fails the phase);
36. a small-input reference for training: reduced smollm-360m (f32, 2
   layers) and rm2 at 4096 rows a table (f32), the same parameters on the
   card and the CPU, 5 steps of ``make_train_step`` (AdamW,
   ``cosine_warmup``, TF32 off): per step loss rtol 1e-4, grad_norm rtol
   1e-3, lr rtol 1e-6; the parameters after the last step atol 2e-4;
37. LM training at full width: smollm-360m in float32 (32 layers, d 960,
   remat ``full``) through the launcher's pieces (``Trainer``,
   ``DataPipeline``, ``CheckpointManager``), batch 8 x 256, 10 steps,
   a checkpoint at step 5; a fresh ``Trainer`` (another seed) restores
   step 5 and runs to step 10, its losses equal to the uninterrupted
   run's (rtol 1e-5); no kernel of the port launches (the
   LM's attention is the reference's plain chunked attention); the init
   peak, step ms p50, tokens/s, and two steps under torch.profiler (busy
   share, ``cudaLaunchKernel`` calls a step);
38. DLRM training at full width: rm1 and rm2 at 1 M rows a table, f32,
   B = 4096, ``adamw(weight_decay=0.0)`` at lr 1e-3, 10 steps of
   ``make_train_step`` through the ``Trainer``: B4's forward and backward
   launches each equal the steps, every loss is finite; step ms p50, two
   profiled steps (busy share, launches, the backward kernel's device
   ms), and the device ms of the forward and of the optimizer's update;
39. the other families, card against CPU: reduced rwkv6-1.6b,
   zamba2-2.7b (4 layers, two groups), whisper-tiny and internvl2-26b in
   float32 (TF32 off), one seeded init on the CPU copied to the card:
   forward logits atol 1e-4, 8 ``decode_step`` logits on the contiguous
   cache (whisper after ``prefill_cross``) atol 1e-4, the loss rtol 1e-5
   and every gradient leaf atol 1e-4 (+ rtol 1e-4);
40. serving them at full width in bf16 with seeded weights
   (``serving/steps.py``), one model on the card at a time, each freed
   before the next (internvl2-26b's 19.9 B parameters alone): the init's
   peak; ``make_prefill_step`` on 8 prompts of 512 tokens (internvl2's 256
   vision-stub embeddings before them, whisper's 1500 stub frames beside
   them), timed; the prompts' first 64 tokens teacher-forced through
   ``decode_step`` beside a full-logits bf16 ``forward`` over the same
   tokens, both held to a float32 forward on the same weights (the
   decode's largest logit error at most twice the bf16 forward's; bf16
   rounds the two forms more than phase 30's two ulps apart), the argmax
   flips between them printed with the forward's top-2 gaps; 32 greedy
   tokens through ``make_serve_step`` (decode ms p50, tokens/s); three
   decode steps under torch.profiler (busy share, ``cudaLaunchKernel``
   calls); the step's byte bound (the weights it reads once and its
   cache at 3.35 TB/s);
41. training them at full width in float32: rwkv6-1.6b and zamba2-2.7b
   through ``repro_torch.launch.train.main`` (AdamW, remat ``full``, 8 x
   256 tokens, 5 steps), whisper-tiny through ``make_train_step`` with
   1500 stub frames a sample (the launcher's batches hold tokens only, as
   the reference's); losses finite, step ms p50, tokens/s, peak memory,
   one step under torch.profiler; internvl2-26b (about 318 GB of f32
   state) trains reduced on the CPU only, through the launcher.  Phases
   40-41 launch none of the seven kernels: the reference runs these
   families outside every Pallas kernel, and every count must stay 0;
42. ``repro_torch.bench.llm_e2e`` (Fig 12, 17 d-e): (a) its smoke
   scenarios on the reference's reduced f32 model and weights under the
   proposer ``off`` and ``ngram``, on the card and on the CPU, every field
   of every row that is not a time (nor ``backend``) equal; (b) llama31-8b
   at full width (bf16, seeded weights) at the reference's full sizes: the
   prefill / decode breakdown at B 16, in 100, out 25/100/400, and every
   scenario through B1, once under ``off`` and once under ``ngram``; each
   row's TTFT / TPOT p50 and p99 and tok/s printed;
43. ``repro_torch.bench.saturation``: overlap off and on on the
   reference's model (steps, idle steps, preemptions and finished equal to
   the CPU run's) with B2's depth x page sweep at its quick sizes, then at
   llama31-8b's full width with the sweep at its full sizes (B2 held to
   its plain version at atol 2e-5 at every point and bit for bit across
   depths, which it ignores), then a pass with ``REPRO_SANITIZE=1`` (zero
   retraces and host-sync trips, allocator checks run);
44. ``python -m repro_torch.bench.run --only llm_e2e,saturation --policy
   fcfs/latest-arrival/lru,priority/most-blocks/hit-rate --spec off,ngram``
   under ``REPRO_BENCH_SMOKE=1``, in its own process: exit 0, saturation
   once a triple, llm_e2e once a (triple, proposer), every row stamped
   with what was forced and its engines running it;
45. ``python -m repro_torch.launch.dryrun --all --probes`` (a process a
   core, up to 8): every cell ``ok`` or the reference's ``skipped``, the
   depth probes equal to the full count (relative 1e-9), the dense
   ``train_4k`` cells' useful-FLOPs ratio in (0.5, 1.2]; then one
   llama31-8b prefill step at 8 x 512 in bf16 on the card, whose
   ``step_costs`` FLOPs equal its meta count: its ms beside the
   roofline's step time and the MFU;
46. energy: rm1 and rm2 at 1 M rows a table, B 4096, SingleTable and
   BatchedTable, NVML's energy counter over loops of at least 2 s
   (``repro_torch.bench.energy``): microjoules an inference and the
   loop's watts, with the idle watts read before the first loop.

Each path (phases 5, 10, 15, 16, 22, 23, 25, 26, 27a, 27b, 28a-c, 29, 30,
34b-d, 37, 38, 40, 41, 42a-b, 43, 45 and 46) runs with every kernel's
launch count set to 0 just before it and read just after.  The card's peaks come
from ``repro_torch.roofline.analysis.HW``.

The ragged and chunked kernels run bf16 prefill owners (two or more lanes)
on the tensor-core tile and everything else on the SIMT tile; their JSON
records say so in ``tile`` and carry the mixed and decode steps' times,
steps and launches (at llama31-8b's width too, under ``llama31_8b``).
Phases 28-30's readings are one JSON line with the card's name and power
limit, phases 31-34's another, phases 35-38's a third, phases
39-41's a fourth and phases 42-46's a fifth.  The line
before the last is the kernels' JSON record (the seven kernels and B4's
backward); the last line is
``{"ok": true, "device": {...}}``.  Without a card the script exits
nonzero before printing either.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.bench.common import device_ms, kernel_ms  # noqa: E402
from repro_torch.bench.turns import card_line  # noqa: E402
from repro_torch.roofline.analysis import H100  # noqa: E402
from repro_torch.serving.metrics import percentile  # noqa: E402

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
TUNE_SPLITS = (64, 128, 256, 512)   # decode splits, in keys, of phase 31
# the kernels JSON line's "tile" of the ragged and chunked kernels, and of
# the decode kernel
PAGED_TILE = ("bf16 owners of >= 2 lanes: attend_tile_mma (wgmma at hd "
              "64/128, mma.sync at 16/32); owners of 1 lane (decode "
              "lanes), f32 or bf16: the decode tile (splits of "
              "num_kv_pages_per_block pages, 256 keys by default, combined "
              "in the launch); f32 owners of >= 2 lanes and padding: "
              "attend_tile (SIMT)")
DECODE_TILE = ("the decode tile: one block per (split of "
               "num_kv_pages_per_block pages, 256 keys by default, kv head),"
               " the splits combined in the launch")
EMB_BATCH = 4096
TRAIN_STEPS = 10                   # phases 37-38
LM_BATCH, LM_SEQ = 8, 256          # phase 37's batches
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


def split_pages(cfg, block_size):
    """The decode split, in pages, that a ragged engine of ``cfg`` resolves
    on the card (the measured table's, else the default): a chunked engine
    whose streams are held to a ragged one's runs the same split, since the
    split sets the bits of a decode lane's softmax."""
    from repro_torch.core import attention_api as api
    from repro_torch.perf import autotune

    a = cfg.attention
    tuned = autotune.resolve_tunables(block_size, a.head_dim, "cuda") or {}
    return api.check_tunables(block_size, a.num_heads // a.num_kv_heads,
                              **tuned)["num_kv_pages_per_block"]


def serve_config(cfg_mod, cfg, attn_impl="ragged", **kw):
    """A ServeConfig for ``cfg``; a chunked one pins the ragged engine's
    split (:func:`split_pages`)."""
    if attn_impl == "chunked":
        kw.setdefault("num_kv_pages_per_block",
                      split_pages(cfg, kw.get("kv_block_size", 128)))
    return cfg_mod.ServeConfig(model=cfg.name, attn_impl=attn_impl, **kw)


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
    """A copy of every leaf on ``dev`` (never the same storage: the
    optimizer updates parameters in place)."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev, copy=True)


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
        self.entries = {}
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
        kind = plan_kind(plan)
        self.kind = kind
        self.steps[kind] = self.steps.get(kind, 0) + 1
        self.want = (kind if kind != "prefill" and kind not in self.got
                     else None)
        if self.want is not None:           # (lanes, drafted) per request
            self.entries[kind] = (
                [(plan.decode_tokens(r), r.req_id in plan.spec)
                 for r in plan.decode] + [(n, False) for _, n in plan.prefill])
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
                         for k in ("prefill", "mixed", "decode", "verify",
                                   "verify+prefill")
                         if k in self.steps)

    def close(self):
        if self.engine is not None:
            self.engine._render = self._render
        setattr(self.api, self.attr, self._op)


def plan_kind(plan):
    """prefill-only, mixed, decode-only, or a drafted step (verify, beside
    prefill chunks or not)."""
    if plan.spec:
        return "verify+prefill" if plan.prefill else "verify"
    return ("mixed" if plan.decode and plan.prefill else
            "decode" if plan.decode else "prefill")


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


def distinct_rows(np, bl, br, bp, owner_keys, block_size):
    """Pool rows (block, offset) that the first ``keys`` keys of each
    ``(owner, keys)`` occupy, a row that several owners read counted once
    (shared prefix blocks, a drafted request's lanes)."""
    bl, br, bp = (t.cpu().numpy() for t in (bl, br, bp))
    rows = set()
    for owner, keys in owner_keys:
        mine = br == owner
        pages = bl[mine][np.argsort(bp[mine], kind="stable")]
        for i, blk in enumerate(pages[:-(-int(keys) // block_size)]):
            n = min(block_size, int(keys) - i * block_size)
            rows.update((int(blk), r) for r in range(n))
    return len(rows)


def ragged_bound(torch, inputs):
    """:func:`bounds` of one ragged call: the distinct K/V rows the live
    sequences' keys occupy (``kv_len`` rows each, not whole pages; a row
    two sequences share counted once) + q of the real lanes + out + the
    int32 lists, over HBM rate, against 4*hd operations per (head, valid
    key) pair over the dtype's peak."""
    import numpy as np

    q, pool, bl, br, bp, cu_q, cu_kv, ss = inputs
    T, H, HD = q.shape
    KV2 = pool.shape[2]
    elt = q.element_size()
    cu_q, cu_kv, ss = cu_q.cpu().numpy(), cu_kv.cpu().numpy(), ss.cpu().numpy()
    S = len(ss)
    live, keys = [], 0
    for j in range(S):
        nq, kvl = cu_q[j + 1] - cu_q[j], cu_kv[j + 1] - cu_kv[j]
        if not 0 <= ss[j] < S or nq <= 0:
            continue
        live.append((ss[j], kvl))
        first = kvl - nq + 1                  # keys seen by the first lane
        keys += int(nq * first + nq * (nq - 1) // 2)
    rows = distinct_rows(np, bl, br, bp, live, pool.shape[1])
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
    """:func:`bounds` of one chunked call: the distinct K/V rows the
    owners of real lanes hold (:func:`distinct_rows`), q of the real lanes,
    out of all lanes and the int32 lists, against 4*hd operations per
    (head, valid key) pair."""
    q, pk, _, bl, br, bp, kv_lens, treq, tpos = inputs
    T, H, HD = q.shape
    KV = pk.shape[2]
    import numpy as np

    kvl = kv_lens.cpu().numpy().astype(np.int64)
    treq, tpos = treq.cpu().numpy(), tpos.cpu().numpy().astype(np.int64)
    real = (treq >= 0) & (treq < len(kvl))
    owners = np.unique(treq[real])
    rows = distinct_rows(np, bl, br, bp, [(o, kvl[o]) for o in owners],
                         pk.shape[1])
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
                    attn_impl="ragged", arch="smollm-360m"):
    """Reduced float32 ``arch`` on the card and on the CPU: one fused
    step's logits on the same rendered lists, and whole greedy streams
    (returned)."""
    cfg = cfg_mod.get_config(arch).reduced(dtype="float32")
    serve = serve_config(cfg_mod, cfg, attn_impl, kv_block_size=4,
                         max_batch=4, prefill_chunk=16)
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
        lists, tokens, *_ = eng._render(eng.scheduler.schedule())
        logits[dev], _ = eng.model.decode_tokens_paged(
            eng.params, eng.pools,
            {k: torch.from_numpy(v).to(dev) for k, v in lists.items()},
            torch.from_numpy(tokens).to(dev), attn_impl=attn_impl,
            attn_tunables=eng.attn_tunables)
        eng = engine(dev)
        eng.run_until_done()
        streams[dev] = {r.req_id: list(r.output) for r in eng.finished}
    err = (logits["cuda"].cpu() - logits["cpu"]).abs().max().item()
    log(f"  reduced f32 {arch} fused step ({attn_impl}), card vs CPU: "
        f"logits max_abs_err {err:.3e} (atol 1e-3)")
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


def split_counts(np, block_req, block_pos, owners, kvls, block_size, kw):
    """'kvl:splits' of each decode-tile owner (one lane): the keys of its
    pages below its kvl (its compacted list) in splits of the call's
    ``num_kv_pages_per_block`` pages (``kw``; default SPLIT_KEYS keys)."""
    from repro_torch.core.attention_api import split_keys_for

    split = split_keys_for(block_size, kw.get("num_kv_pages_per_block", 0))
    req = block_req.cpu().numpy()
    pos = block_pos.cpu().numpy().astype(np.int64)
    out = []
    for o, k in zip(owners, kvls):
        keys = int(((req == o) & (pos * block_size < k)).sum()) * block_size
        out.append(f"{int(k)}:{max(1, -(-keys // split))}")
    return f"(splits of {split} keys) " + " ".join(out)


def ragged_splits(np, inputs, kw):
    """split_counts of a ragged call's sequences of one lane."""
    _, pool, _, br, bp, cu_q, cu_kv, ss = inputs
    cu_q, cu_kv = cu_q.cpu().numpy(), cu_kv.cpu().numpy()
    one = [j for j in range(len(cu_q) - 1) if cu_q[j + 1] - cu_q[j] == 1]
    return split_counts(np, br, bp, ss.cpu().numpy()[one],
                        [cu_kv[j + 1] - cu_kv[j] for j in one], pool.shape[1],
                        kw)


def decode_splits(np, inputs, kw):
    """split_counts of a decode call's requests."""
    _, pk, _, _, br, bp, seq_lens = inputs
    lens = seq_lens.cpu().numpy()
    return split_counts(np, br, bp, range(len(lens)), lens, pk.shape[1], kw)


def chunked_splits(np, inputs, kw):
    """split_counts of a chunked call's owners of one lane."""
    _, pk, _, _, br, bp, kv_lens, treq, _ = inputs
    kvl = kv_lens.cpu().numpy()
    owners, lanes = np.unique(treq.cpu().numpy(), return_counts=True)
    one = [o for o, n in zip(owners, lanes) if n == 1 and 0 <= o < len(kvl)]
    return split_counts(np, br, bp, one, [kvl[o] for o in one], pk.shape[1],
                        kw)


def serve_chunked(torch, np, cfg_mod, engine_mod, api, counted, model,
                  params, cfg, prompts, served, dev):
    """Phase 15: phase 5's requests through attn_impl="chunked"; returns
    the chunked kernel's launches and the captured layer-0 inputs."""
    def engine(attn_impl, num_blocks):
        serve = serve_config(cfg_mod, cfg, attn_impl,
                             kv_block_size=SERVE_BS, max_batch=SERVE_BATCH)
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
    capture.got["ms_per_step"] = 1e3 * (t_end - t0) / steps
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
    rows = bench.run(dev, tune=False)   # phase 32 runs the sweep
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
        limit = share(again, *inputs)
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


def busy_ms(torch, fn, n=5):
    """Device ms per call of ``fn``: its kernels' device time summed under
    torch.profiler over ``n`` calls, after one untimed call (the card's
    work without the gaps the host's launches leave)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        total += us if us is not None else getattr(e, "self_cuda_time_total",
                                                   0)
    return total / n / 1e3


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
               emb_api.embedding_bag_backward, *stream_ops.OPS,
               *gs_ops.OPS, flash_attention)
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
    phase5 = dict(wall=wall, p50_tpot_s=m["p50_tpot_s"],
                  p99_tpot_s=m["p99_tpot_s"])

    # 6. captured inputs: kernel vs plain, and times ---------------------------
    log("== 6. layer-0 inputs of real steps: kernel vs plain, times")
    steps = {}
    for kind in ("decode", "mixed"):
        inputs, kw, out_run = capture.got[kind]
        q, _, bl, _, _, cu_q, cu_kv, ss = inputs
        log(f"  {kind} step (nq, kvl) per sequence: "
            f"{lanes_by_sequence(cu_q, cu_kv)}")
        log(f"  {kind} step decode-tile sequences (one lane), kvl:splits "
            f"{ragged_splits(np, inputs, kw)}")
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
    phase5["profile"] = profile_decode(torch, np, model, params, cfg, serve,
                                       engine_mod, dev)
    log("== 7b. profile of phase 5's first mixed step (phase 5's requests)")
    mixed_profile = profile_mixed(torch, model, params, cfg, serve,
                                  engine_mod, prompts, dev)

    smollm_steps = {k: capture.got[k][:2] for k in ("decode", "mixed")}
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
            f"kvl:splits {chunked_splits(np, inputs, kw)}")
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
    phase16_ms = d_capture["ms_per_step"]
    log(f"  decode_step_paged last step, kvl:splits per request "
        f"{decode_splits(np, inputs, kw)}")
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

    # 25. trace-replay parity at BENCH_009.json's size -------------------------
    log("== 25. trace replay, reduced smollm-360m f32: card vs CPU vs "
        "BENCH_009.json")
    t25 = time.perf_counter()
    replay_parity(torch, counted, dev)
    log(f"  phase 25: {time.perf_counter() - t25:.1f} s")

    # 26. the sweep at full width ---------------------------------------------
    log("== 26. trace replay at full width: smollm-360m (32 layers, bf16), "
        "4 scenarios x 7 configurations + draft-model on mixed")
    t26 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    replay = replay_sweep(torch, counted, model, params, cfg, dev, card)
    log(f"  phase 26: {time.perf_counter() - t26:.1f} s")

    # 27. the overlapped loop and the verify step at full width --------------
    log("== 27a. phase 5's requests with overlap=True")
    t27 = time.perf_counter()
    overlap = serve_overlap(torch, np, cfg_mod, engine_mod, counted, model,
                            params, cfg, prompts, served, phase5, dev, card)
    log("== 27b. phase 5's requests with spec='ngram', spec_k 3")
    verify_in = serve_spec(torch, cfg_mod, engine_mod, api, counted, model,
                           params, cfg, prompts, served, dev, card)
    del model, params
    torch.cuda.empty_cache()
    log("== 27c. the ragged and chunked kernels on a verify step's layer-0 "
        "inputs")
    verify = {}
    for attn_impl, op, bound, share in (
            ("ragged", api.paged_attention_ragged_op, ragged_bound,
             api.ragged_bf16_share),
            ("chunked", api.paged_attention_chunked_op, chunked_bound,
             lambda got, *a, **kw: api.chunked_bf16_share(got, *a))):
        inputs, kw, out_run = verify_in[attn_impl]["inputs"]
        if attn_impl == "ragged":
            log(f"  verify step (nq, kvl) per sequence: "
                f"{lanes_by_sequence(inputs[5], inputs[6])}")
        verify[attn_impl] = kernel_times(
            torch, op, inputs, kw, out_run, bound(torch, inputs),
            f"{attn_impl} verify step T={inputs[0].shape[0]}", card,
            share=share)
        verify[attn_impl].update(
            {k: v for k, v in verify_in[attn_impl].items()
             if k not in ("inputs", "entries")})
    verify["ragged"]["grouped"] = grouped_verify(
        torch, np, api, verify_in["ragged"], card)
    log(f"  phase 27: {time.perf_counter() - t27:.1f} s")

    # 28-30. the paper's LLM at full width ------------------------------------
    del verify_in
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== 28. llama31-8b at full width (32 layers, bf16, seeded weights); "
        f"device memory held before it "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    t28 = time.perf_counter()
    llama, model8, params8, llama_steps = llama_phase28(
        torch, np, cfg_mod, engine_mod, api, counted, build_model, prompts,
        phase5, phase16_ms, dev, card)
    cfg8 = model8.cfg
    log(f"  phase 28: {time.perf_counter() - t28:.1f} s")
    log("== 29. the host KV tier at llama31-8b's width")
    t29 = time.perf_counter()
    llama["tier"] = llama_phase29(torch, np, cfg_mod, engine_mod, counted,
                                  model8, params8, cfg8, dev, card)
    log(f"  phase 29: {time.perf_counter() - t29:.1f} s")
    log("== 30. disaggregated prefill/decode at llama31-8b's width: the "
        "burst, mono against split")
    t30 = time.perf_counter()
    llama["disagg"] = llama_phase30(torch, np, cfg_mod, engine_mod, counted,
                                    build_model, model8, params8, cfg8, dev,
                                    card)
    log(f"  phase 30: {time.perf_counter() - t30:.1f} s")
    log(json.dumps({"llama31_8b": llama, "card": card}))

    # 31-34. the tunables, the sweep, the sanitizers, MoE serving ----------
    captures = {"smollm-360m": smollm_steps, "llama31-8b": llama_steps}
    log("== 31. the paged kernels' tunables against the plain version")
    t31 = time.perf_counter()
    tunables = tunables_phase(torch, np, api, pa_kernel, build, builds,
                              captures, ragged_case, dev, card)
    log(f"  phase 31: {time.perf_counter() - t31:.1f} s")
    log("== 32. the autotune sweep, the committed table, resolved against "
        "default")
    t32 = time.perf_counter()
    tune = tune_phase(torch, np, cfg_mod, engine_mod, api, captures,
                      prompts, model8, params8, cfg8, dev, card)
    log(f"  phase 32: {time.perf_counter() - t32:.1f} s")
    del captures, smollm_steps, llama_steps, model8, params8
    gc.collect()
    torch.cuda.empty_cache()
    log("== 33. sanitized serving")
    t33 = time.perf_counter()
    sanitized = sanitize_phase(torch, np, cfg_mod, engine_mod, build_model,
                               prompts, served, dev, card)
    log(f"  phase 33: {time.perf_counter() - t33:.1f} s")
    log("== 34. MoE: reduced granite-moe and qwen3-moe card vs CPU, then "
        "granite-moe-1b-a400m at full width")
    t34 = time.perf_counter()
    granite = moe_phase(torch, np, cfg_mod, engine_mod, api, counted,
                        build_model, prompts, dev, card)
    log(f"  phase 34: {time.perf_counter() - t34:.1f} s")
    log(json.dumps({"tunables": tunables, "tune": tune,
                    "sanitize": sanitized, "granite_moe": granite,
                    "card": card}, default=str))

    # 35-38. B4's backward, training card vs CPU, LM and DLRM training ------
    log("== 35. the B4 backward kernel against its plain version, rm1/rm2 "
        "full widths; times, bound, registers")
    t35 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory still held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    bwd_errs = [backward_check(torch, cfg_mod.get_config(arch), emb_api, dev)
                for arch in ("rm1", "rm2")]
    bwd = {arch: backward_times(torch, cfg_mod.get_config(arch), build_model,
                                emb_api, dev, card)
           for arch in ("rm1", "rm2")}
    bwd_inst = backward_ptxas(build, builds, card)
    bwd_err = max([b["max_abs_err"] for b in bwd.values()] + bwd_errs)
    log(f"  phase 35: {time.perf_counter() - t35:.1f} s")
    log("== 36. training card vs CPU: reduced smollm-360m and rm2 (4096 "
        "rows), 5 AdamW steps")
    t36 = time.perf_counter()
    train_ref = training_reference_check(torch, cfg_mod, build_model, dev)
    log(f"  phase 36: {time.perf_counter() - t36:.1f} s")
    log(f"== 37. smollm-360m training at full width, f32, {LM_BATCH} x "
        f"{LM_SEQ}, {TRAIN_STEPS} steps, a checkpoint and a restore")
    t37 = time.perf_counter()
    lm_train = lm_training(torch, cfg_mod, build_model, counted, dev, card)
    log(f"  phase 37: {time.perf_counter() - t37:.1f} s")
    log(f"== 38. DLRM training, rm1/rm2 at 1 M rows a table, B={EMB_BATCH}, "
        f"{TRAIN_STEPS} steps")
    t38 = time.perf_counter()
    dlrm_train, bwd_launches = dlrm_training(torch, cfg_mod, build_model,
                                             emb_api, counted, dev, card)
    log(f"  phase 38: {time.perf_counter() - t38:.1f} s")
    log(json.dumps({"backward": bwd, "train_reference": train_ref,
                    "lm_training": lm_train, "dlrm_training": dlrm_train,
                    "card": card}, default=str))

    # 39-41. the other model families: card vs CPU, serving, training ------
    log("== 39. the other families card vs CPU: reduced rwkv6, zamba2, "
        "whisper and internvl2 in f32 (forward, 8 decode steps, loss and "
        "gradients)")
    t39 = time.perf_counter()
    fam_ref = families_reference_check(torch, np, cfg_mod, build_model, dev)
    log(f"  phase 39: {time.perf_counter() - t39:.1f} s")
    log(f"== 40. serving the families at full width, bf16: prefill "
        f"{FAM_BATCH} x {FAM_PROMPT}, {FAM_TEACHER} teacher-forced decode "
        f"steps against the forward, {FAM_GREEDY} greedy")
    t40 = time.perf_counter()
    fam_serve = {}
    for arch in FAMILIES:
        t = time.perf_counter()
        fam_serve[arch] = family_serving(torch, np, cfg_mod, build_model,
                                         counted, arch, dev, card)
        log(f"  {arch}: {time.perf_counter() - t:.1f} s")
    log(f"  phase 40: {time.perf_counter() - t40:.1f} s")
    log(f"== 41. training the families at full width, f32, "
        f"{FAM_TRAIN_STEPS} steps")
    t41 = time.perf_counter()
    fam_train = {arch: launcher_training(torch, counted, arch, FAM_BATCH,
                                         card)
                 for arch in ("rwkv6-1.6b", "zamba2-2.7b")}
    fam_train["whisper-tiny"] = whisper_training(
        torch, np, cfg_mod, build_model, counted, dev, card)
    fam_train["internvl2-26b"] = internvl_training_cpu()
    log(f"  phase 41: {time.perf_counter() - t41:.1f} s")
    log(json.dumps({"families_reference": fam_ref,
                    "families_serving": fam_serve,
                    "families_training": fam_train, "card": card},
                   default=str))

    # 42-46. end-to-end serving figures, the sweeps, the roofline, energy --
    log("== 42. llm_e2e: the smoke scenarios card against CPU (reference "
        "model, off / ngram), then llama31-8b at full width, bf16, the "
        "reference's full sizes (off / ngram)")
    t42 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model8 = build_model(cfg_mod.get_config("llama31-8b"), device=dev)
    params8 = model8.init(seed=0)
    e2e = llm_e2e_phase(torch, cfg_mod, build_model, api, counted, model8,
                        params8, dev, card)
    log(f"  phase 42: {time.perf_counter() - t42:.1f} s")
    log("== 43. saturation: overlap off / on (reference model, card against "
        "CPU; llama31-8b full width), B2's depth x page sweep, sanitized")
    t43 = time.perf_counter()
    sat = saturation_phase(torch, build_model, api, counted, model8, params8,
                           dev, card)
    log(f"  phase 43: {time.perf_counter() - t43:.1f} s")
    del model8, params8
    gc.collect()
    torch.cuda.empty_cache()
    log("== 44. bench.run --only llm_e2e,saturation: two policy triples x "
        "two proposers, REPRO_BENCH_SMOKE=1")
    t44 = time.perf_counter()
    sweeps = harness_phase(torch, card)
    log(f"  phase 44: {time.perf_counter() - t44:.1f} s")
    log("== 45. the roofline: launch.dryrun --all --probes; llama31-8b "
        "prefill 8 x 512 on the card against its meta count")
    t45 = time.perf_counter()
    roof = roofline_phase(torch, cfg_mod, build_model, counted, dev, card)
    log(f"  phase 45: {time.perf_counter() - t45:.1f} s")
    log(f"== 46. energy: rm1 / rm2 at 1 M rows, B={EMB_BATCH}, BatchedTable "
        "and SingleTable, NVML's energy counter")
    t46 = time.perf_counter()
    power = energy_phase(torch, emb_api, counted, dev, card)
    log(f"  phase 46: {time.perf_counter() - t46:.1f} s")
    log(json.dumps({"llm_e2e": e2e, "saturation": sat, "sweeps": sweeps,
                    "roofline": roof, "energy": power, "card": card},
                   default=str))

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
        "verify": verify["ragged"], "replay": replay, "overlap": overlap,
        "llama31_8b": dict(llama["ragged"]["kernel"],
                           launches=llama["ragged"]["launches"]),
        "granite_moe": dict(granite["ragged"]["kernel"],
                            launches=granite["ragged"]["launches"]),
        "tunables": {k: tunables[k] for k in ("max_abs_err", "bf16_share")},
        "tune_table": tune["table"],
        "instances": ragged_inst}, {
        "name": CHUNKED_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{CHUNKED_KERNEL}.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:293",
        "launches": c_launches, **chunked_top, "library_ms": None,
        "max_abs_diff_vs_ragged": ragged_diff, "tile": PAGED_TILE,
        "decode": chunked_steps["decode"], "mixed": chunked_steps["mixed"],
        "verify": verify["chunked"],
        "llama31_8b": dict(llama["chunked"]["kernel"],
                           launches=llama["chunked"]["launches"]),
        "granite_moe": dict(granite["chunked"]["kernel"],
                            launches=granite["chunked"]["launches"]),
        "instances": chunked_inst}, {
        "name": DECODE_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{DECODE_KERNEL}.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:89",
        "launches": d_launches, **dict(decode_top, max_abs_err=max(
            decode_top["max_abs_err"], decode_err)),
        "library_ms": None, "tile": DECODE_TILE,
        "llama31_8b": llama["decode"], "granite_moe": granite["decode"],
        "instances": decode_inst}, {
        "name": EMB_KERNEL, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{EMB_KERNEL}.cu",
        "replaces": "src/repro/kernels/batched_embedding/kernel.py:41",
        "launches": emb_launches, **emb["rm2"], "max_abs_err": emb_err,
        "rm1": emb["rm1"], "rm2": emb["rm2"]}, {
        "name": "batched_embedding_backward", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{EMB_KERNEL}.cu",
        "replaces": "src/repro/kernels/batched_embedding/kernel.py:41",
        "gradient_of": "src/repro/core/embedding_api.py:45 (jax.grad; the "
                       "TPU side has no backward kernel)",
        "launches": bwd_launches,
        **{k: bwd["rm2"][k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
        "max_abs_err": bwd_err, "rm1": bwd["rm1"], "rm2": bwd["rm2"],
        "instances": bwd_inst}, {
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


def serve_at_width(torch, np, cfg_mod, engine_mod, api, counted, model,
                   params, cfg, prompts, attn_impl, dev, card):
    """One run of phase 5's requests at the width of ``cfg`` (llama31-8b,
    granite-moe-1b-a400m) through ``attn_impl``: a short warm-up engine first, then the run with layer
    0's inputs of a mixed and a decode-only step captured; the kernel's
    launches must equal steps x layers (the other paged kernel's 0), the
    allocator's invariants must hold and the pool must drain.  Returns
    (greedy streams, metrics, launches, capture)."""
    serve = serve_config(cfg_mod, cfg, attn_impl, kv_block_size=SERVE_BS,
                         max_batch=SERVE_BATCH)
    warm = engine_mod.ServingEngine(model, params, cfg, serve,
                                    num_blocks=256, device=dev)
    for i, p in prompts[:2]:
        warm.submit(engine_mod.Request(req_id=i, prompt=p[:64],
                                       max_new_tokens=4))
    warm.run_until_done()
    del warm
    eng = engine_mod.ServingEngine(model, params, cfg, serve,
                                   num_blocks=SERVE_BLOCKS, device=dev)
    attr, other = (("paged_attention_ragged_op", 1) if attn_impl == "ragged"
                   else ("paged_attention_chunked_op", 0))
    op = getattr(api, attr)                     # holds the launch count
    capture = Capture(api, attr, eng)
    reset_counts(counted)
    wall = serve_phase5(engine_mod, eng, prompts, torch)
    launches, stray = op.launches, counted[other].launches
    capture.close()
    m = eng.metrics()
    log(f"  {attn_impl}: steps {m['steps']}  output tokens "
        f"{m['output_tokens']}  wall {wall:.3f}s  output tok/s "
        f"{m['output_tokens'] / wall:.1f}  lane tokens/step "
        f"{m['lane_tokens_per_step']:.1f}  [{card}]")
    log(f"  TTFT p50 {m['p50_ttft_s'] * 1e3:.1f} / p99 "
        f"{m['p99_ttft_s'] * 1e3:.1f} ms  TPOT p50 "
        f"{m['p50_tpot_s'] * 1e3:.2f} / p99 {m['p99_tpot_s'] * 1e3:.2f} ms  "
        f"prefix hit rate {m['prefix_hit_rate']:.3f}  preemptions "
        f"{m['preemptions']}")
    log(f"  kernel launches {launches} = steps x layers {m['steps']} x "
        f"{cfg.num_layers}; the other paged kernel {stray}")
    log(f"  steps by kind: {capture.by_kind()}")
    if launches != m["steps"] * cfg.num_layers or launches == 0 or stray:
        raise AssertionError(f"{attn_impl}: launches {launches} != steps x "
                             f"layers, or the other kernel ran {stray}")
    if m["finished"] != len(prompts):
        raise AssertionError(f"finished {m['finished']} of {len(prompts)}")
    for r in eng.finished:
        if len(r.output) != SERVE_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.req_id}: bad output {r.output}")
    eng.alloc.check_invariants(drained=True)
    log("  allocator invariants hold; pool drained "
        f"({eng.alloc.num_free}/{eng.alloc.num_blocks} blocks free)")
    for kind in ("mixed", "decode"):
        if kind not in capture.got:
            raise AssertionError(f"no {kind} step captured")
    streams = {r.req_id: list(r.output) for r in eng.finished}
    keep = ("steps", "output_tokens", "p50_ttft_s", "p99_ttft_s",
            "p50_tpot_s", "p99_tpot_s")
    return streams, dict({k: m[k] for k in keep}, wall=wall,
                         tok_s=m["output_tokens"] / wall), launches, capture


def llama_kernel_steps(torch, np, api, capture, attn_impl, card,
                       label="llama31-8b"):
    """The paged kernel of ``attn_impl`` on the captured layer-0 inputs of
    a decode-only and a mixed step: against its plain version at phase
    3's bf16 limit, its time beside both bounds (phase 6's readings)."""
    op, bound, share, splits = (
        (api.paged_attention_ragged_op, ragged_bound, api.ragged_bf16_share,
         ragged_splits) if attn_impl == "ragged" else
        (api.paged_attention_chunked_op, chunked_bound,
         lambda got, *a, **kw: api.chunked_bf16_share(got, *a),
         chunked_splits))
    out = {}
    for kind in ("decode", "mixed"):
        inputs, kw, out_run = capture.got[kind]
        if attn_impl == "ragged":
            log(f"  {kind} step (nq, kvl) per sequence: "
                f"{lanes_by_sequence(inputs[5], inputs[6])}")
        log(f"  {kind} step decode-tile owners, kvl:splits "
            f"{splits(np, inputs, kw)}")
        out[kind] = kernel_times(
            torch, op, inputs, kw, out_run, bound(torch, inputs),
            f"{label} {attn_impl} {kind} step T={inputs[0].shape[0]} "
            f"H={inputs[0].shape[1]} hd={inputs[0].shape[2]}", card,
            share=share)
        out[kind].update(steps=capture.steps.get(kind, 0),
                         launches=capture.launches.get(kind, 0))
    return out


def llama_phase28(torch, np, cfg_mod, engine_mod, api, counted, build_model,
                  prompts, phase5, phase16_ms, dev, card):
    """Phases 28a-c: llama31-8b at full width (32 layers, bf16, seeded
    weights) through the ragged kernel, the chunked kernel and the paper
    path.  Returns (the phase's readings, model, params, the ragged
    kernel's layer-0 inputs and keywords of 28a's decode-only and mixed
    steps)."""
    cfg = cfg_mod.get_config("llama31-8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    a = cfg.attention
    log(f"  params {n_params / 1e9:.3f} B ({n_params * 2 / 1e9:.2f} GB "
        f"bf16), H {a.num_heads} KV {a.num_kv_heads} hd {a.head_dim} "
        f"G {a.num_heads // a.num_kv_heads}; init "
        f"{time.perf_counter() - t0:.1f}s; peak device memory after init "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = dict(params=n_params)
    log("== 28a. llama31-8b: phase 5's requests, ragged (B1)")
    streams, out["ragged"], launches, cap = serve_at_width(
        torch, np, cfg_mod, engine_mod, api, counted, model, params, cfg,
        prompts, "ragged", dev, card)
    out["ragged"]["launches"] = launches
    out["ragged"]["kernel"] = llama_kernel_steps(torch, np, api, cap,
                                                 "ragged", card)
    steps = {k: cap.got[k][:2] for k in ("decode", "mixed")}
    del cap
    log("  three decode-only steps under torch.profiler (phase 7's "
        "workload at this width):")
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                max_batch=SERVE_BATCH)
    prof = profile_decode(torch, np, model, params, cfg, serve, engine_mod,
                          dev)
    before = phase5["profile"]
    log(f"  busy share {prof['busy_share']:.1%} of {prof['wall_ms']:.3f} "
        f"ms/step, {prof['launches']:.0f} cudaLaunchKernel / step "
        f"(smollm-360m, phase 7: {before['busy_share']:.1%} of "
        f"{before['wall_ms']:.3f} ms/step, {before['launches']:.0f})  "
        f"[{card}]")
    out["decode_profile"] = {k: prof[k] for k in
                             ("wall_ms", "busy_ms", "busy_share", "launches")}
    log("== 28b. llama31-8b: the same requests, attn_impl='chunked' (B2)")
    c_streams, out["chunked"], c_launches, c_cap = serve_at_width(
        torch, np, cfg_mod, engine_mod, api, counted, model, params, cfg,
        prompts, "chunked", dev, card)
    if c_streams != streams:
        diff = [i for i in streams if c_streams.get(i) != streams[i]]
        raise AssertionError(f"chunked greedy streams differ from 28a's "
                             f"ragged streams for requests {diff}")
    log(f"  greedy streams identical to 28a's ragged run ({len(streams)} "
        f"requests x {SERVE_NEW} tokens)")
    out["chunked"]["launches"] = c_launches
    out["chunked"]["kernel"] = llama_kernel_steps(torch, np, api, c_cap,
                                                  "chunked", card)
    del c_cap
    log(f"== 28c. llama31-8b: decode_step_paged (B3), 16 requests, "
        f"{PAPER_PROMPT} prompt tokens one per step, {PAPER_NEW} greedy")
    d_launches, d_cap = paper_path(torch, np, api, counted, model, params,
                                   cfg, dev)
    log(f"  {d_cap['ms_per_step']:.2f} ms/step (smollm-360m, phase 16: "
        f"{phase16_ms:.2f})  [{card}]")
    inputs, kw, out_run = d_cap["decode"]
    log(f"  last step, kvl:splits per request "
        f"{decode_splits(np, inputs, kw)}")
    out["decode"] = kernel_times(
        torch, api.paged_attention_op, inputs, kw, out_run,
        decode_bound(torch, inputs),
        f"llama31-8b decode_step_paged last step B={inputs[0].shape[0]} "
        f"H={inputs[0].shape[1]} hd={inputs[0].shape[2]}", card)
    out["decode"].update(launches=d_launches,
                         ms_per_step=d_cap["ms_per_step"])
    return out, model, params, steps


def tier_copy_ms(torch, pool, reps=5):
    """Mean ms of the tier drain's block copies on ``pool``: a demote's
    read of one block of every layer to host memory, and a promote's write
    of it back (``core/paged_kv.read_pool_block`` / ``write_pool_block``,
    synchronised, each of the pool's blocks ``reps`` times)."""
    from repro_torch.core.paged_kv import read_pool_block, write_pool_block

    d2h, h2d, n = 0.0, 0.0, 0
    for _ in range(reps):
        for blk in range(pool.shape[1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            data = read_pool_block(pool, blk)
            t1 = time.perf_counter()
            write_pool_block(pool, blk, data)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            d2h, h2d, n = d2h + t1 - t0, h2d + t2 - t1, n + 1
    return 1e3 * d2h / n, 1e3 * h2d / n, data.numel() * data.element_size()


def llama_phase29(torch, np, cfg_mod, engine_mod, counted, model, params,
                  cfg, dev, card):
    """Phase 29: the host KV tier at llama31-8b's width: the round trip
    (starved run's streams equal the roomy run's, demotes and promotes,
    no leak), then the reference benchmark's tier-pressure scenario, lru
    without a host tier against tiered with 20 host blocks, and the
    tier's block copy times."""
    from repro_torch.bench import disagg as bench

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (17,), dtype=np.int32)
    filler = rng.integers(0, cfg.vocab_size, (17,), dtype=np.int32)

    def rounds(num_blocks):
        serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=4,
                                    max_batch=1, eviction="tiered",
                                    host_blocks=8)
        eng = engine_mod.ServingEngine(model, params, cfg, serve,
                                       num_blocks=num_blocks, device=dev)
        outs = []
        for i, p in enumerate([prompt, prompt, filler, prompt]):
            eng.submit(engine_mod.Request(req_id=i, prompt=p,
                                          max_new_tokens=4))
            eng.run_until_done()
            outs.append(list(eng.finished[-1].output))
        return outs, eng

    out = {}
    reset_counts(counted)
    roomy, _ = rounds(64)
    starved, eng = rounds(7)
    launches = counted[0].launches
    hp = eng.host_pool.counters
    log(f"  round trip [prompt, prompt, filler, prompt], 17-token prompts, "
        f"block size 4, tiered, 8 host blocks: roomy (64 blocks) "
        f"{roomy}; starved (7 blocks) {starved}; tier {dict(hp)}; ragged "
        f"launches {launches}")
    if starved != roomy:
        raise AssertionError("the starved run's streams differ from the "
                             "roomy run's: the tier round trip lost KV")
    if not (hp["demotes"] > 0 and hp["promotes"] > 0) or launches == 0:
        raise AssertionError(f"no demote / promote (or no launch): {hp}")
    eng.alloc.check_invariants(drained=True)
    if eng.metrics()["blocks_free"] != 7:
        raise AssertionError("a block leaked under tier traffic")
    log("  starved streams identical to the roomy run's; allocator "
        "invariants hold, pool drained")
    out["round_trip"] = dict(hp)
    sizes = bench.FULL
    rows = {}
    for eviction, host in (("lru", 0), ("tiered", 4 * sizes["n_prompts"])):
        eng = bench.pressure_engine(model, params, cfg, sizes, eviction,
                                    host, dev)
        reset_counts(counted)
        wall = bench.pressure_run(eng, cfg, sizes, dev)
        m = eng.metrics()
        t = m["tier"]
        rows[eviction] = dict(
            prefix_hit_rate=m["prefix_hit_rate"],
            prefix_hits=m["prefix_hits"],
            evictions=eng.alloc.cache_evictions, demotes=t["demotes"],
            promotes=t["promotes"], tier_hits=t["hits"], drops=t["drops"],
            finished=m["finished"], wall=wall,
            launches=counted[0].launches)
        log(f"  tier pressure {eviction:6s} host {host:2d}: "
            + "  ".join(f"{k} {v:.3f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in rows[eviction].items())
            + f"  [{card}]")
        eng.alloc.check_invariants(drained=True)
        if rows[eviction]["launches"] == 0:
            raise AssertionError("the tier scenario launched no kernel")
        pool = eng.pools["kv"]
    if not (rows["tiered"]["prefix_hit_rate"]
            > rows["lru"]["prefix_hit_rate"]):
        raise AssertionError(f"tiered hit rate is not higher: {rows}")
    d2h, h2d, nbytes = tier_copy_ms(torch, pool)
    log(f"  tier block copies ({nbytes / 2**20:.2f} MiB a block, "
        f"{pool.shape[1]} blocks x 5): demote (device to host) {d2h:.4f} "
        f"ms, promote (host to device) {h2d:.4f} ms, means  [{card}]")
    out.update(pressure=rows, d2h_ms=d2h, h2d_ms=h2d, block_bytes=nbytes)
    return out


def bf16_ulp(v: float) -> float:
    import math

    return 2.0 ** (math.floor(math.log2(abs(v))) - 7) if v else 2.0 ** -133


def llama_phase30(torch, np, cfg_mod, engine_mod, counted, build_model,
                  model, params, cfg, dev, card):
    """Phase 30: the reference's burst at llama31-8b's width, mono against
    split.  Split's greedy streams equal mono's, or part from them only at
    a token where mono's top two logits lie within two bf16 ulps (a
    sampling hook records them); then the same burst in float32 at depth 4
    must give identical streams."""
    import dataclasses

    from repro_torch.bench import disagg as bench

    sizes = bench.FULL
    sampling = engine_mod.sampling_lib
    sample = sampling.sample_batched
    last = {}

    def hooked(gen, logits, *args):
        tok = sample(gen, logits, *args)
        last["top2"] = logits.float().topk(2, dim=-1).values
        return tok

    def run(model, params, cfg, roles, gaps=None):
        eng = bench.burst_engine(model, params, cfg, sizes, roles, dev)
        if gaps is not None:
            build = eng._build

            def build_and_record(*args):
                pend = build(*args)
                for kind, req, _, _, out_idx in pend.actions:
                    if out_idx is not None:
                        gaps[(req.req_id, out_idx)] = last["top2"][
                            pend.slots[req.req_id]]
                return pend

            eng._build = build_and_record
        reset_counts(counted)
        wall = bench.drain(eng, dev)
        launches = counted[0].launches
        streams = {r.req_id: list(r.output) for r in eng.finished}
        return eng, wall, streams, launches

    sampling.sample_batched = hooked
    try:
        gaps = {}
        mono, mono_wall, mono_streams, mono_launches = run(
            model, params, cfg, "", gaps)
    finally:
        sampling.sample_batched = sample
    split, split_wall, split_streams, split_launches = run(
        model, params, cfg, "prefill,decode")
    mono.alloc.check_invariants(drained=True)
    for e in (split.pre, split.dec):
        e.alloc.check_invariants(drained=True)
    burst, _ = bench.prompts_of(cfg.vocab_size, sizes)
    full = sum(len(p) >= sizes["bs"] for p in burst)
    if split.num_handoffs != full or split._staged or split._pending_handoffs:
        raise AssertionError(
            f"handoffs {split.num_handoffs} != {full}, or staging left "
            f"{split._staged} {list(split._pending_handoffs)}")
    if not mono_launches or not split_launches:
        raise AssertionError("the burst launched no ragged kernel")
    out = {}
    for tag, eng, wall, launches in (("mono", mono, mono_wall, mono_launches),
                                     ("split", split, split_wall,
                                      split_launches)):
        m = eng.metrics()
        out[tag] = dict(wall=wall, launches=launches, finished=m["finished"],
                        **{k: m[k] for k in ("p50_tpot_s", "p99_tpot_s",
                                             "p50_ttft_s", "p99_ttft_s")})
        line = (f"  {tag:5s}: wall {wall:.3f}s  TPOT p50 "
                f"{m['p50_tpot_s'] * 1e3:.2f} / p99 "
                f"{m['p99_tpot_s'] * 1e3:.2f} ms  TTFT p50 "
                f"{m['p50_ttft_s'] * 1e3:.1f} / p99 "
                f"{m['p99_ttft_s'] * 1e3:.1f} ms  ragged launches {launches}")
        if tag == "split":
            r = m["roles"]
            out[tag].update(handoffs=m["handoffs"],
                            handoff_p50_ms=m["handoff_ms"]["p50"],
                            prefill_steps=r["prefill"]["steps"],
                            decode_steps=r["decode"]["steps"])
            line += (f"  handoffs {m['handoffs']} (p50 "
                     f"{m['handoff_ms']['p50']:.2f} ms)  steps prefill "
                     f"{r['prefill']['steps']} / decode "
                     f"{r['decode']['steps']}")
        else:
            out[tag]["steps"] = m["steps"]
            line += f"  steps {m['steps']}"
        log(line + f"  [{card}]")
        if m["finished"] != sizes["n_req"]:
            raise AssertionError(f"{tag}: finished {m['finished']}")
    parity = {}
    for rid, want in sorted(mono_streams.items()):
        got = split_streams[rid]
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if j is None:
            if len(got) != len(want):
                raise AssertionError(f"request {rid}: {len(got)} tokens "
                                     f"split, {len(want)} mono")
            parity[rid] = "identical"
            continue
        top1, top2 = (float(v) for v in gaps[(rid, j)].cpu())
        ulps = (top1 - top2) / bf16_ulp(top1)
        parity[rid] = f"token {j}: mono's top-2 gap {ulps:.2f} bf16 ulps"
        if not ulps <= 2:
            raise AssertionError(f"request {rid}: split leaves mono's stream "
                                 f"at token {j} where mono's top two logits "
                                 f"are {ulps:.2f} bf16 ulps apart")
    log("  split against mono, bf16: " + "; ".join(
        f"{rid} {v}" for rid, v in parity.items()))
    out["parity_bf16"] = parity
    del mono, split
    cfg4 = dataclasses.replace(cfg, num_layers=4, dtype="float32")
    model4 = build_model(cfg4, device=dev)
    params4 = model4.init(seed=0)
    _, _, mono4, _ = run(model4, params4, cfg4, "")
    split4_eng, _, split4, _ = run(model4, params4, cfg4, "prefill,decode")
    if split4 != mono4:
        diff = [i for i in mono4 if split4.get(i) != mono4[i]]
        raise AssertionError(f"float32 depth 4: split streams differ from "
                             f"mono's for requests {diff}")
    for e in (split4_eng.pre, split4_eng.dec):
        e.alloc.check_invariants(drained=True)
    log(f"  float32, depth 4: split streams identical to mono's "
        f"({len(mono4)} requests x {sizes['max_new']} tokens)")
    out["parity_f32_depth4"] = "identical"
    return out


def replay_parity(torch, counted, dev):
    """Phase 25: the sweep at BENCH_009.json's size on the card and on the
    CPU; rows against each other, against BENCH_009.json (the caveat rows
    against the CPU run) and through the gate."""
    import tempfile

    from repro_torch.bench import trace_replay as tr
    from repro_torch.perf import gate

    runs = {}
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        cfg, model, params = tr.build("smollm-360m", True, d)
        reset_counts(counted)
        runs[str(d)] = tr.sweep(model, params, cfg, device=d,
                                log=lambda _: None)
        launches = counted[0].launches
        steps = sum(r["metrics"]["steps"] for r in runs[str(d)])
        log(f"  {str(d):4s}: {len(runs[str(d)])} rows, {steps} forward "
            f"steps in {time.perf_counter() - t0:.1f} s; ragged launches "
            f"{launches}")
    if launches != steps * cfg.num_layers or not launches:
        raise AssertionError(f"ragged launches {launches} != forward steps "
                             f"x layers {steps} x {cfg.num_layers}")
    card, cpu = runs["cuda"], runs["cpu"]
    bench = {r["name"]: r["derived"] for r in tr.baseline(
        {r["name"]: r["derived"] for r in cpu})[0]["rows"]}
    for rc, rp in zip(card, cpu):
        name, got = rc["name"], tr.parse_derived(rc["derived"])
        if rc["name"] != rp["name"] or got != tr.parse_derived(rp["derived"]) \
                or rc["outputs"] != rp["outputs"]:
            raise AssertionError(f"{name}: card row differs from the CPU's: "
                                 f"{rc['derived']} != {rp['derived']}")
        if got != tr.parse_derived(bench[name]):
            raise AssertionError(f"{name}: differs from BENCH_009.json: "
                                 f"{rc['derived']} != {bench[name]}")
        where = ("the CPU run (a reference caveat)"
                 if name in tr.REFERENCE_CAVEATS else "BENCH_009.json")
        log(f"  {name}: = CPU, = {where}: steps {got['steps']} "
            f"p99_ttft_steps {got['p99_ttft_steps']} p99_tpot_steps "
            f"{got['p99_tpot_steps']} prefix_hits {got['prefix_hits']} "
            f"preempt {got['preempt']}"
            + (f" resolved {got['resolved']}" if "resolved" in got else ""))
    with tempfile.TemporaryDirectory() as tmp:
        base, cur = Path(tmp) / "baseline.json", Path(tmp) / "card.json"
        base.write_text(json.dumps(tr.baseline(
            {r["name"]: r["derived"] for r in cpu})))
        cur.write_text(json.dumps(tr.to_json(card, device="cuda")))
        rc = gate.main(["--baseline", str(base), "--current", str(cur)])
    if rc != 0:
        raise AssertionError(f"perf gate against BENCH_009.json: exit {rc}")


def replay_sweep(torch, counted, model, params, cfg, dev, card):
    """Phase 26: the sweep at full width; returns the ragged kernel's
    launches, the forward steps and the rows' numbers."""
    from repro_torch.bench import trace_replay as tr

    torch.cuda.synchronize()
    reset_counts(counted)
    recs = tr.sweep(model, params, cfg, device=dev, draft=("mixed",),
                    log=lambda _: None)
    torch.cuda.synchronize()
    launches = counted[0].launches
    steps = sum(r["metrics"]["steps"] for r in recs)
    rows = {}
    for r in recs:
        d, m, slo = tr.parse_derived(r["derived"]), r["metrics"], r["slo"]
        s = m["spec"]
        rows[r["name"]] = dict(
            wall_ms=r["us_per_call"] / 1e3, steps=int(d["steps"]),
            p50_ttft_vs=slo["p50_ttft_s"], p99_ttft_vs=slo["p99_ttft_s"],
            p50_tpot_s=m["p50_tpot_s"], p99_tpot_s=m["p99_tpot_s"],
            accept_rate=s["acceptance_rate"])
        log(f"  {r['name']}: steps {d['steps']} finished {d['finished']} "
            f"out_tokens {d['out_tokens']} tok/step {d['tok_per_step']} "
            f"p99 ttft/tpot steps {d['p99_ttft_steps']}/"
            f"{d['p99_tpot_steps']} prefix_hits {d['prefix_hits']} preempt "
            f"{d['preempt']} slo_ok {d['slo_ok']}"
            + (f" resolved {d['resolved']}" if "resolved" in d else ""))
        log(f"    wall {r['us_per_call'] / 1e3:.1f} ms  TTFT p50 "
            f"{slo['p50_ttft_s']:.2f} / p99 {slo['p99_ttft_s']:.2f} virtual s"
            f"  TPOT p50 {m['p50_tpot_s']:.4f} / p99 {m['p99_tpot_s']:.4f} s"
            + (f"  spec {s['proposer']} accept rate "
               f"{s['acceptance_rate']:.3f} ({s['accepted_tokens']} of "
               f"{s['proposed_tokens']})" if s["proposer"] != "off" else "")
            + f"  [{card}]")
    log(f"  ragged launches {launches} = forward steps x layers {steps} x "
        f"{cfg.num_layers}")
    if launches != steps * cfg.num_layers:
        raise AssertionError("ragged launches != forward steps x layers")
    by_name = {r["name"]: r for r in recs}
    for scenario in tr.SCENARIOS:
        want = by_name[f"trace_{scenario}_fcfs"]["outputs"]
        for label in ("ngram", "overlap", "draft"):
            r = by_name.get(f"trace_{scenario}_{label}")
            if r is not None and r["outputs"] != want:
                diff = [i for i in want if r["outputs"].get(i) != want[i]]
                raise AssertionError(f"{r['name']}: greedy streams differ "
                                     f"from the fcfs row's for {diff}")
    log("  ngram, overlap and draft-model streams = their fcfs twin's; auto "
        "resolved on every axis, no worse than the best fixed triple; every "
        "pool drained")
    return dict(launches=launches, steps=steps, rows=rows)


def grouped_verify(torch, np, api, captured, card):
    """Phase 27c: the captured verify step's lanes regrouped as the
    reference renders them (a drafted request one owner of 1 + k lanes,
    which B1 runs on the tensor-core tile) against the engine's rendering
    (each drafted lane an owner of its own, on the decode tile): the
    kernel's time, its bounds, and how far the two outputs differ."""
    (q, pool, bl, br, bp, cu_q, cu_kv, ss), kw, out_run = captured["inputs"]
    cu_q, cu_kv, ss = (t.cpu().numpy() for t in (cu_q, cu_kv, ss))
    nq, kvl = np.diff(cu_q), np.diff(cu_kv)
    O = len(ss)
    seqs, remap, j = [], {}, 0
    for lanes, drafted in captured["entries"]:
        if drafted:     # lane 0's owner is the slot, the last one's the table
            ids = ss[j:j + lanes]
            remap.update({int(o): O for o in ids[:-1]})
            remap[int(ids[-1])] = int(ids[0])
            seqs.append((ids[0], lanes, kvl[j + lanes - 1]))
            j += lanes
        else:
            seqs.append((ss[j], nq[j], kvl[j]))
            j += 1
    br_new = np.asarray([remap.get(int(o), int(o))
                         for o in br.cpu().numpy()], np.int32)
    seq_slot = np.full((O,), O, np.int32)
    cq, ck = np.zeros((O + 1,), np.int32), np.zeros((O + 1,), np.int32)
    for i, (slot, n, keys) in enumerate(seqs):
        seq_slot[i] = slot
        cq[i + 1], ck[i + 1] = cq[i] + n, ck[i] + keys
    cq[len(seqs) + 1:], ck[len(seqs) + 1:] = cq[len(seqs)], ck[len(seqs)]
    dev = q.device
    grouped = [q, pool, bl, torch.from_numpy(br_new).to(dev), bp,
               torch.from_numpy(cq).to(dev), torch.from_numpy(ck).to(dev),
               torch.from_numpy(seq_slot).to(dev)]
    op = api.paged_attention_ragged_op
    out = op(*grouped, **kw)
    torch.cuda.synchronize()
    n = int(cu_q[-1])
    diff = (out[:n].float() - out_run[:n].float()).abs().max().item()
    log(f"  grouped as the reference renders it (nq, kvl): "
        f"{[(int(a), int(b)) for _, a, b in seqs]}")
    log(f"  grouped against the engine's per-lane owners: max |diff| "
        f"{diff:.3e}, {'the same bits' if diff == 0 else 'other bits'}")
    res = kernel_times(torch, op, grouped, kw, out,
                       ragged_bound(torch, grouped),
                       f"ragged verify step grouped T={q.shape[0]}", card,
                       share=api.ragged_bf16_share)
    res["max_abs_diff_vs_per_lane"] = diff
    return res


def serve_phase5(engine_mod, eng, prompts, torch):
    """Phase 5's requests through ``eng``; returns the wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in prompts:
        eng.submit(engine_mod.Request(req_id=i, prompt=p,
                                      max_new_tokens=SERVE_NEW))
    eng.run_until_done()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_served(eng, served, launches, cfg, what):
    m = eng.metrics()
    streams = {r.req_id: list(r.output) for r in eng.finished}
    if streams != served:
        diff = [i for i in served if streams.get(i) != served[i]]
        raise AssertionError(f"{what}: greedy streams differ from phase 5's "
                             f"for requests {diff}")
    if launches != m["steps"] * cfg.num_layers:
        raise AssertionError(f"{what}: launches {launches} != steps x layers "
                             f"{m['steps']} x {cfg.num_layers}")
    eng.alloc.check_invariants(drained=True)
    log(f"  {what}: greedy streams identical to phase 5's; launches "
        f"{launches} = steps x layers {m['steps']} x {cfg.num_layers}; pool "
        "drained")
    return m


def serve_overlap(torch, np, cfg_mod, engine_mod, counted, model, params,
                  cfg, prompts, served, phase5, dev, card):
    """Phase 27a: the overlapped loop with its build half under
    ``set_sync_debug_mode("error")``, then overlap off / on in turns, then
    phase 7's decode-only profile with overlap on."""
    def engine(overlap):
        serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                    max_batch=SERVE_BATCH, overlap=overlap)
        return engine_mod.ServingEngine(model, params, cfg, serve,
                                        num_blocks=SERVE_BLOCKS, device=dev)

    eng = engine(True)
    build, guarded = eng._build, []

    def build_no_sync(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return build(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            guarded.append(1)

    eng._build = build_no_sync
    reset_counts(counted)
    wall = serve_phase5(engine_mod, eng, prompts, torch)
    m = check_served(eng, served, counted[0].launches, cfg, "overlap=True")
    log(f"  {len(guarded)} build halves ran under set_sync_debug_mode"
        "('error'): none waited for the card")
    log(f"  wall {wall:.3f} s (phase 5 {phase5['wall']:.3f})  TPOT p50 "
        f"{m['p50_tpot_s'] * 1e3:.2f} / p99 {m['p99_tpot_s'] * 1e3:.2f} ms "
        f"(phase 5 {phase5['p50_tpot_s'] * 1e3:.2f} / "
        f"{phase5['p99_tpot_s'] * 1e3:.2f})  [{card}]")
    turns = []
    for overlap in (False, True, True, False):
        e = engine(overlap)
        w = serve_phase5(engine_mod, e, prompts, torch)
        mt = e.metrics()
        turns.append(dict(overlap=overlap, wall=w,
                          p50_tpot_s=mt["p50_tpot_s"],
                          p99_tpot_s=mt["p99_tpot_s"]))
        log(f"  in turns, overlap {'on ' if overlap else 'off'}: wall "
            f"{w:.3f} s  TPOT p50 {mt['p50_tpot_s'] * 1e3:.2f} / p99 "
            f"{mt['p99_tpot_s'] * 1e3:.2f} ms  TTFT p50 "
            f"{mt['p50_ttft_s'] * 1e3:.1f} ms")
        del e
    log("  three decode-only steps with overlap on (phase 7's workload):")
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                max_batch=SERVE_BATCH, overlap=True)
    prof = profile_decode(torch, np, model, params, cfg, serve, engine_mod,
                          dev)
    before = phase5["profile"]
    log(f"  busy share {prof['busy_share']:.1%} of {prof['wall_ms']:.3f} "
        f"ms/step (overlap off, phase 7: {before['busy_share']:.1%} of "
        f"{before['wall_ms']:.3f} ms/step)  [{card}]")
    keep = ("wall_ms", "busy_ms", "busy_share", "launches")
    return dict(build_halves=len(guarded), wall=wall,
                p50_tpot_s=m["p50_tpot_s"], p99_tpot_s=m["p99_tpot_s"],
                turns=turns, profile={k: prof[k] for k in keep},
                serial_profile={k: before[k] for k in keep})


def serve_spec(torch, cfg_mod, engine_mod, api, counted, model, params, cfg,
               prompts, served, dev, card):
    """Phase 27b: ngram speculative decoding, ragged then chunked; returns
    per kernel the launches, steps by kind and the captured layer-0 inputs
    of the first verify step without prefill lanes."""
    out = {}
    for attn_impl, attr in (("ragged", "paged_attention_ragged_op"),
                            ("chunked", "paged_attention_chunked_op")):
        serve = serve_config(cfg_mod, cfg, attn_impl,
                             kv_block_size=SERVE_BS, max_batch=SERVE_BATCH,
                             spec="ngram", spec_k=3)
        eng = engine_mod.ServingEngine(model, params, cfg, serve,
                                       num_blocks=SERVE_BLOCKS, device=dev)
        op = getattr(api, attr)                 # holds the launch count
        capture = Capture(api, attr, eng)
        reset_counts(counted)
        wall = serve_phase5(engine_mod, eng, prompts, torch)
        launches = op.launches
        capture.close()
        m = check_served(eng, served, launches, cfg, f"ngram {attn_impl}")
        s = m["spec"]
        log(f"  accept rate {s['acceptance_rate']:.3f} ({s['accepted_tokens']}"
            f" of {s['proposed_tokens']} drafts)  drafted steps "
            f"{s['drafted_steps']} of {m['steps']}  tokens / drafted lane "
            f"{s['tokens_per_decode_lane']:.2f}  wall {wall:.3f} s  TPOT p50 "
            f"{m['p50_tpot_s'] * 1e3:.2f} / p99 {m['p99_tpot_s'] * 1e3:.2f} "
            f"ms  [{card}]")
        log(f"  steps by kind: {capture.by_kind()}")
        if "verify" not in capture.got:
            raise AssertionError("no verify step without prefill captured")
        out[attn_impl] = dict(inputs=capture.got["verify"],
                              entries=capture.entries["verify"],
                              launches=launches, steps=m["steps"],
                              accept_rate=s["acceptance_rate"],
                              steps_by_kind=capture.steps)
        del eng, capture
    return out


def profile_decode(torch, np, model, params, cfg, serve, engine_mod, dev):
    """torch.profiler over three decode-only engine steps: device time by
    kernel, and the device's busy share of the steps' wall time (returned
    as :func:`profile_calls` gives it)."""
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
    return profile_calls(torch, eng.step, 3, "decode steps", "step")


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
    rows = recsys_e2e.run(dev, energy=False)   # phase 46 reads energy
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


def bf16_refs(api, q, pool_k, pool_v, ints):
    """``want`` and ``M`` of phase 3's bf16 limit (``chunked_bf16_share``)
    on float32 q and k, computed once for many outputs."""
    qf, kf = q.float(), pool_k.float()
    return (api.paged_attention_chunked(qf, kf, pool_v, *ints).float(),
            api.paged_attention_chunked(qf, kf, pool_v.abs(), *ints).float())


def bf16_limit(got, want, m):
    """Largest |got - want| / (2^-7 (M + |want|) + 1e-4): at most 1."""
    from repro_torch.kernels.flash_attention.ref import BF16_FLOOR, BF16_REL

    return ((got.float() - want).abs()
            / (BF16_REL * (m + want.abs()) + BF16_FLOOR)).max().item()


def tune_points(block_size):
    """Phase 31's (pages per split, [rows per tile]) of the ragged kernel:
    each split of TUNE_SPLITS that holds whole pages, at 128 and 64 query
    rows a tensor-core tile (128 // G and 64 // G lanes)."""
    return [(split // block_size, [64, 128]) for split in TUNE_SPLITS
            if split % block_size == 0]


def held_to_plain(torch, got, want, atol, refs, what):
    """``got`` against the plain version's ``want`` (atol), and in bf16 the
    per-element limit against ``refs`` (:func:`bf16_refs`).  Returns
    (max_abs_err, limit share or None)."""
    err = (got.float() - want.float()).abs().max().item()
    if not err <= atol:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version: {err} > {atol}")
    if refs is None:
        return err, None
    share = bf16_limit(got, *refs)
    if not share <= 1:
        raise AssertionError(f"{what}: {share:.3f}x the bf16 limit")
    return err, share


def tunables_ragged(torch, api, args, kw, what):
    """B1 at every split and rows per tile of :func:`tune_points`, and B2
    at every split, on one set of ragged lanes: each held to the plain
    version (f32 atol 2e-5; bf16 atol 2e-2 and phase 3's limit), the two
    tile heights and B2 bitwise equal to one another at each split.
    Returns (max_abs_err, worst bf16 share)."""
    from repro_torch.core.paged_kv import fused_kv_views

    q, pool, bl, br, bp, cu_q, cu_kv, ss = args
    BS, G = pool.shape[1], q.shape[1] * 2 // pool.shape[2]
    pk, pv = fused_kv_views(pool)
    treq, tpos, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                               ss.shape[0])
    ints = (bl, br, bp, kvl, treq, tpos)
    bf16 = q.dtype == torch.bfloat16
    atol = 2e-2 if bf16 else 2e-5
    want = api.paged_attention_ragged(*args)
    refs = bf16_refs(api, q, pk, pv, ints) if bf16 else None
    errs, shares, seen = [0.0], [0.0], []
    for pages, rows in tune_points(BS):
        outs = [api.paged_attention_ragged_op(
            *args, **dict(kw, num_queries_per_block=n,
                          num_kv_pages_per_block=pages)) for n in rows]
        outs.append(api.paged_attention_chunked_op(
            q, pk, pv, *ints, num_kv_pages_per_block=pages))
        torch.cuda.synchronize()
        for got in outs:
            err, share = held_to_plain(torch, got, want, atol, refs,
                                       f"{what} split {pages * BS}")
            errs.append(err)
            shares.append(share or 0.0)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"{what} split {pages * BS}: rows per "
                                 "tile or the chunked kernel changed a bit")
        seen.append(pages * BS)
    log(f"  {what}: splits {seen} keys x rows per tile {[64, 128]} (lanes "
        f"{[64 // G, 128 // G]} at G {G}), and B2: max_abs_err "
        f"{max(errs):.3e}"
        + (f", bf16 limit {max(shares):.4f}" if bf16 else "")
        + "; at each split both tile heights and B2 bitwise equal")
    return max(errs), max(shares)


def tunables_decode(torch, np, api, c, dtype, what, dev):
    """B3 at every split of TUNE_SPLITS that holds whole pages on a decode
    case, held to ``paged_attention_opt``, and B2 and B1 on the same lanes
    (``cases.decode_lanes``) bitwise equal to it at each split."""
    from repro_torch.core.paged_kv import fused_kv_views
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, CHUNKED_ARG_ORDER, DECODE_ARG_ORDER, decode_lanes)

    lanes = decode_lanes(c)
    args = [torch.from_numpy(c[k]).to(dev) for k in DECODE_ARG_ORDER]
    args[:3] = [a.to(dtype) for a in args[:3]]
    rargs = [torch.from_numpy(lanes[k]).to(dev) for k in ARG_ORDER]
    rargs[:2] = [a.to(dtype) for a in rargs[:2]]
    cargs = [rargs[0], *fused_kv_views(rargs[1]),
             *[torch.from_numpy(lanes[k]).to(dev) for k in CHUNKED_ARG_ORDER]]
    bf16 = dtype == torch.bfloat16
    want = api.paged_attention_opt(*args)
    refs = bf16_refs(api, cargs[0], cargs[1], cargs[2], cargs[3:]) \
        if bf16 else None
    BS = args[1].shape[1]
    errs, seen = [0.0], []
    for split in TUNE_SPLITS:
        if split % BS:
            continue
        kw = dict(num_kv_pages_per_block=split // BS)
        d = api.paged_attention_op(*args, **kw)
        ch = api.paged_attention_chunked_op(*cargs, **kw)
        r = api.paged_attention_ragged_op(*rargs, **kw)
        torch.cuda.synchronize()
        errs.append(held_to_plain(torch, d, want, 2e-2 if bf16 else 2e-5,
                                  refs, f"{what} split {split}")[0])
        if not (torch.equal(d, ch) and torch.equal(d, r)):
            raise AssertionError(f"{what} split {split}: decode, chunked "
                                 "and ragged not bitwise equal")
        seen.append(split)
    log(f"  {what}: B3 at splits {seen}: max_abs_err {max(errs):.3e}; "
        "decode == chunked == ragged bitwise at each")
    return max(errs)


def decode_form(torch, np, api, args):
    """A decode-only ragged step as the decode kernel's call: request s is
    slot s, its q row the lane the slot owns (``seq_lens`` 0 for a slot
    with none), the BlockList as it is.  Returns (args, the lane of each
    slot or -1)."""
    from repro_torch.core.paged_kv import fused_kv_views

    q, pool, bl, br, bp, cu_q, cu_kv, ss = args
    _, _, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                         ss.shape[0])
    S = ss.shape[0]
    cu, slots = cu_q.cpu().numpy(), ss.cpu().numpy()
    lane_of = np.full((S,), -1, np.int64)
    for j in range(S):
        if cu[j + 1] - cu[j] == 1 and 0 <= slots[j] < S:
            lane_of[slots[j]] = cu[j]
    has = torch.from_numpy(lane_of >= 0).to(q.device)
    qd = q[torch.from_numpy(lane_of.clip(0)).to(q.device)].contiguous()
    lens = torch.where(has, kvl, 0).to(torch.int32)
    return [qd, *fused_kv_views(pool), bl, br, bp, lens], lane_of


def cap_check(torch, api, pa_kernel, source, op, args, kw, what):
    """``vmem_limit_bytes`` at the launch's request and one byte below it:
    the first must give the uncapped bits, the second a ValueError naming
    both sizes."""
    q = args[0]
    G = q.shape[1] * 2 // args[1].shape[2] if op is \
        api.paged_attention_ragged_op else q.shape[1] // args[1].shape[2]
    need = pa_kernel.smem_bytes(source, q.shape[2],
                                int(q.dtype == torch.bfloat16), G)
    base = op(*args, **kw)
    got = op(*args, **dict(kw, vmem_limit_bytes=need))
    torch.cuda.synchronize()
    if not torch.equal(got, base):
        raise AssertionError(f"{what}: a cap of {need} B changed a bit")
    try:
        op(*args, **dict(kw, vmem_limit_bytes=need - 1))
    except ValueError as e:
        if str(need - 1) not in str(e) or str(need) not in str(e):
            raise AssertionError(f"{what}: the refusal names neither size: "
                                 f"{e}") from e
    else:
        raise AssertionError(f"{what}: a launch requesting {need} B ran "
                             f"under a cap of {need - 1} B")
    steps = [f"{need} B runs, same bits", f"{need - 1} B refused"]
    log(f"  {what} vmem_limit_bytes: " + "; ".join(steps))
    return steps


def tunables_phase(torch, np, api, pa_kernel, build, builds, captures,
                   ragged_case, dev, card):
    """Phase 31: the kernels' tunables against the plain version."""
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, LONG_DECODE, LONG_WIDTHS, decode_case)

    errs = []
    for name, shape in synthetic_cases():
        c = ragged_case(np.random.default_rng(0), **shape)
        for dname, _ in DTYPES:
            dtype = getattr(torch, dname)
            args = [torch.from_numpy(c[k]).to(dev) for k in ARG_ORDER]
            args[:2] = [a.to(dtype) for a in args[:2]]
            errs.append(tunables_ragged(torch, api, args, {},
                                        f"{name} {dname}")[0])
    cases = [("decode, sorted BlockList", dict(FULL_WIDTHS, **DECODE_CASE))]
    cases += [(f"long-context decode, {n} widths",
               dict(LONG_WIDTHS[n], **LONG_DECODE))
              for n in sorted(LONG_WIDTHS)]
    for name, shape in cases:
        c = decode_case(np.random.default_rng(1), **shape)
        for dname, _ in DTYPES:
            errs.append(tunables_decode(torch, np, api, c,
                                        getattr(torch, dname),
                                        f"{name} {dname}", dev))
    shares = [0.0]
    for arch, steps in sorted(captures.items()):
        for kind in ("decode", "mixed"):
            args, kw = steps[kind]
            e, sh = tunables_ragged(torch, api, args, kw,
                                    f"{arch} captured {kind} step bf16")
            errs.append(e)
            shares.append(sh)
        args, kw = steps["decode"]
        dargs, lane_of = decode_form(torch, np, api, args)
        has = lane_of >= 0
        BS = args[1].shape[1]
        for split in TUNE_SPLITS:
            pages = dict(num_kv_pages_per_block=split // BS)
            r = api.paged_attention_ragged_op(*args, **dict(kw, **pages))
            d = api.paged_attention_op(*dargs, **pages)
            torch.cuda.synchronize()
            if not torch.equal(d[torch.from_numpy(has).to(dev)],
                               r[torch.from_numpy(lane_of[has]).to(dev)]):
                raise AssertionError(f"{arch} captured decode step, split "
                                     f"{split}: B3 != B1 on its lanes")
        log(f"  {arch} captured decode step: B3 == B1 bitwise on its "
            f"{int(has.sum())} decode lanes at splits {list(TUNE_SPLITS)}")
    caps = {}
    c = decode_case(np.random.default_rng(1),
                    **dict(LONG_WIDTHS["smollm-360m"], **LONG_DECODE))
    lanes = decode_lanes_on(torch, c, dev)
    for dname, _ in DTYPES:
        dtype = getattr(torch, dname)
        for source, op, key in (
                (KERNEL, api.paged_attention_ragged_op, "ragged"),
                (CHUNKED_KERNEL, api.paged_attention_chunked_op, "chunked"),
                (DECODE_KERNEL, api.paged_attention_op, "decode")):
            args = [a.to(dtype) if a.is_floating_point() else a
                    for a in lanes[key]]
            caps[f"{key} {dname}"] = cap_check(
                torch, api, pa_kernel, source, op, args, {},
                f"{key} {dname} (long-context decode lanes)")
    spills = []
    for source in (KERNEL, CHUNKED_KERNEL, DECODE_KERNEL):
        rows = build.ptxas_report(builds[source]["log"])
        spills += [r["entry"] for r in rows
                   if r.get("spill_stores") or r.get("spill_loads")]
        log(f"  {source}: {len(rows)} instances, registers "
            f"{min(r['registers'] for r in rows)}-"
            f"{max(r['registers'] for r in rows)}, no spill  [{card}]")
    if spills:
        raise AssertionError(f"spills: {spills}")
    return dict(max_abs_err=max(errs), bf16_share=max(shares), caps=caps)


def decode_lanes_on(torch, c, dev):
    """A decode case's arguments of the three kernels on ``dev`` (float32):
    ``{"decode", "chunked", "ragged"}``."""
    from repro_torch.core.paged_kv import fused_kv_views
    from repro_torch.kernels.paged_attention.cases import (
        ARG_ORDER, CHUNKED_ARG_ORDER, DECODE_ARG_ORDER, decode_lanes)

    lanes = decode_lanes(c)
    ragged = [torch.from_numpy(lanes[k]).to(dev) for k in ARG_ORDER]
    return {"decode": [torch.from_numpy(c[k]).to(dev)
                       for k in DECODE_ARG_ORDER],
            "ragged": ragged,
            "chunked": [ragged[0], *fused_kv_views(ragged[1]),
                        *[torch.from_numpy(lanes[k]).to(dev)
                          for k in CHUNKED_ARG_ORDER]]}


def tune_phase(torch, np, cfg_mod, engine_mod, api, captures, prompts,
               model, params, cfg, dev, card):
    """Phase 32: the autotune sweep on the captured steps, the committed
    table, an engine of ``cfg`` (llama31-8b, the cell whose winner is not
    the default) that resolves from it, and phase 5's workload served by
    that model with the resolved tunables and with the defaults in
    turns."""
    from repro_torch.bench import paged_attention_bench as bench
    from repro_torch.perf import autotune
    from repro_torch.perf.table import parse_derived

    vocab = cfg_mod.get_config("smollm-360m").vocab_size
    if not all(np.array_equal(a, b) for a, (_, b) in
               zip(bench.phase5_prompts(vocab), prompts)):
        raise AssertionError("the sweep's workload is not phase 5's")
    cells = {(16, 64): captures["smollm-360m"],
             (16, 128): captures["llama31-8b"]}
    rows = bench.autotune_sweep(dev, cells, card)
    sweep = {}
    for r in rows:
        cell = f"({r['page_size']}, {r['head_dim']}, {r['backend']})"
        split = api.split_keys_for(r["page_size"],
                                   r["num_kv_pages_per_block"])
        log(f"  {cell} rows {r['num_queries_per_block']:3d} pages "
            f"{r['num_kv_pages_per_block']:3d} (split {split} keys): "
            f"{r['ms']:.4f} ms = 31 x {r['decode_ms']:.4f} + 4 x "
            f"{r['mixed_ms']:.4f}; default {r['default_ms']:.4f} ms"
            + ("  [default]" if r["default"] else "")
            + ("  BEST" if r["best"] else ""))
        sweep.setdefault(cell, []).append(
            {k: r[k] for k in ("num_queries_per_block",
                               "num_kv_pages_per_block", "ms", "decode_ms",
                               "mixed_ms", "best", "default")})
    log(f"  [{card}]")
    # the committed table: both cells, defaults in each grid, its card
    path = str(autotune.PACKAGED_TUNE_TABLE)
    results = json.loads(Path(path).read_text())
    table = autotune.TuneTable.load(path)
    for BS, HD in cells:
        if table.lookup(BS, HD, "cuda") is None:
            raise AssertionError(f"{path}: no cell ({BS}, {HD}, cuda)")
        grid = [parse_derived(r["derived"]) for res in results
                for r in res["rows"] if "tune=1" in r["derived"]]
        grid = [d for d in grid if d["page_size"] == str(BS)
                and d["head_dim"] == str(HD) and d["backend"] == "cuda"]
        if not any(all(d[k] == str(v)
                       for k, v in api.TUNABLE_DEFAULTS.items())
                   for d in grid):
            raise AssertionError(f"{path} ({BS}, {HD}): no default point")
        log(f"  committed table ({BS}, {HD}, cuda): "
            f"{table.lookup(BS, HD, 'cuda')} of {len(grid)} points, "
            f"measured on {grid[0].get('card')}")
    # an engine with every key at 0 resolves from it
    resolved = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                   max_batch=SERVE_BATCH)
    eng = engine_mod.ServingEngine(model, params, cfg, resolved,
                                   num_blocks=256, device=dev)
    m = eng.metrics()
    want = table.lookup(SERVE_BS, cfg.attention.head_dim, "cuda")
    got = {k: m[k] for k in autotune.TUNABLE_KEYS}
    if m["policy_counters"]["tune.tuned_resolved"] != 1 or got != want:
        raise AssertionError(f"the engine did not resolve the table: {got} "
                             f"{m['policy_counters']}")
    log(f"  a {cfg.name} engine with the keys at 0: tune.tuned_resolved 1, "
        f"{got}")
    del eng
    # the defaults, given explicitly: 0 pages (the kernels' own split)
    # would consult the table, so the same split in pages
    default = api.check_tunables(SERVE_BS, 1)
    explicit = cfg_mod.ServeConfig(
        model=cfg.name, kv_block_size=SERVE_BS, max_batch=SERVE_BATCH,
        num_queries_per_block=default["num_queries_per_block"],
        num_kv_pages_per_block=api.SPLIT_KEYS // SERVE_BS)
    out = dict(sweep=sweep, table={f"{k}": v for k, v in
                                   table.best.items()})
    # B1 on this model's captured steps at each config
    cell = cells[(SERVE_BS, cfg.attention.head_dim)]
    b1 = {}
    for tag, tun in (("resolved", got), ("default", default)):
        b1[tag] = {kind: kernel_ms(api.paged_attention_ragged_op,
                                   *cell[kind][0], device=dev, reps=100,
                                   **dict(cell[kind][1], **tun))
                   for kind in ("decode", "mixed")}
    sampling = engine_mod.sampling_lib
    sample = sampling.sample_batched
    last, gaps, runs = {}, {}, {}

    def hooked(gen, logits, *args):
        tok = sample(gen, logits, *args)
        last["top2"] = logits.float().topk(2, dim=-1).values
        return tok

    for tag in ("resolved", "default", "default", "resolved"):
        eng = engine_mod.ServingEngine(
            model, params, cfg, resolved if tag == "resolved" else explicit,
            num_blocks=SERVE_BLOCKS, device=dev)
        record = tag == "resolved" and tag not in runs
        if record:
            build_half = eng._build

            def build_and_record(*args):
                pend = build_half(*args)
                for _, req, _, _, out_idx in pend.actions:
                    if out_idx is not None:
                        gaps[(req.req_id, out_idx)] = last["top2"][
                            pend.slots[req.req_id]]
                return pend

            eng._build = build_and_record
            sampling.sample_batched = hooked
        try:
            wall = serve_phase5(engine_mod, eng, prompts, torch)
        finally:
            sampling.sample_batched = sample
        m = eng.metrics()
        eng.alloc.check_invariants(drained=True)
        streams = {r.req_id: list(r.output) for r in eng.finished}
        runs.setdefault(tag, []).append(dict(
            wall=wall, p50_tpot_s=m["p50_tpot_s"], p99_tpot_s=m["p99_tpot_s"],
            streams=streams))
        log(f"  in turns, {tag:8s}: TPOT p50 {m['p50_tpot_s'] * 1e3:.2f} / "
            f"p99 {m['p99_tpot_s'] * 1e3:.2f} ms  wall {wall:.3f}s  B1 "
            f"decode {b1[tag]['decode']:.4f} / mixed {b1[tag]['mixed']:.4f}"
            f" ms  [{card}]")
        del eng
    want_s, got_s = runs["resolved"][0]["streams"], runs["default"][0][
        "streams"]
    parity = {}
    for rid, w in sorted(want_s.items()):
        g = got_s[rid]
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            parity[rid] = "identical"
            continue
        if api.split_keys_for(SERVE_BS, got["num_kv_pages_per_block"]) \
                == api.SPLIT_KEYS:
            raise AssertionError(f"request {rid}: streams differ at an "
                                 "equal split")
        top1, top2 = (float(v) for v in gaps[(rid, j)].cpu())
        ulps = (top1 - top2) / bf16_ulp(top1)
        parity[rid] = f"token {j}: top-2 gap {ulps:.2f} bf16 ulps"
        if not ulps <= 2:
            raise AssertionError(f"request {rid}: the default split leaves "
                                 f"the resolved stream at token {j}, a top-2 "
                                 f"gap of {ulps:.2f} bf16 ulps")
    for tag in runs:
        if any(r["streams"] != runs[tag][0]["streams"] for r in runs[tag]):
            raise AssertionError(f"{tag}: two runs gave other streams")
    log("  resolved against default streams: " + "; ".join(
        f"{rid} {v}" for rid, v in parity.items()))
    out.update(b1=b1, parity=parity, turns={
        tag: [{k: v for k, v in r.items() if k != "streams"} for r in rs]
        for tag, rs in runs.items()})
    return out


def sanitize_phase(torch, np, cfg_mod, engine_mod, build_model, prompts,
                   served, dev, card):
    """Phase 33: the reference's sanitized smoke on the card, phase 5's
    workload sanitized with overlap on, and a control that must trip."""
    from repro_torch.analysis import sanitize as san_lib

    cfg = cfg_mod.get_config("smollm-360m").reduced(dtype="float32")
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=8, max_batch=1,
                                overlap=True, eviction="tiered",
                                host_blocks=12, sanitize=True)
    eng = engine_mod.ServingEngine(model, params, cfg, serve, num_blocks=7,
                                   device=dev)
    rng = np.random.default_rng(1)
    three = [rng.integers(0, cfg.vocab_size, (24,), dtype=np.int32)
             for _ in range(3)]
    rid = 0
    for _ in range(2):
        for p in three:
            for _ in range(2):
                eng.submit(engine_mod.Request(req_id=rid, prompt=p,
                                              max_new_tokens=4))
                rid += 1
            eng.run_until_done()
    san = eng.metrics()["sanitize"]
    if not (san["enabled"] and san["retraces"] == 0
            and san["transfer_guard_trips"] == 0
            and san["invariant_checks"] > 0 and san["allowed_host_syncs"] > 0):
        raise AssertionError(f"sanitized smoke: {san}")
    eng.alloc.check_invariants(drained=True)
    log(f"  reference smoke (overlap, tiered, 12 host / 7 HBM blocks): {san}")
    out = {"smoke": san}
    del eng, model, params
    cfg = cfg_mod.get_config("smollm-360m")
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                max_batch=SERVE_BATCH, overlap=True,
                                sanitize=True)
    eng = engine_mod.ServingEngine(model, params, cfg, serve,
                                   num_blocks=SERVE_BLOCKS, device=dev)
    wall = serve_phase5(engine_mod, eng, prompts, torch)
    m = eng.metrics()
    san = m["sanitize"]
    streams = {r.req_id: list(r.output) for r in eng.finished}
    if streams != served:
        raise AssertionError("sanitized streams differ from phase 5's")
    if san["retraces"] or san["transfer_guard_trips"] or not san[
            "invariant_checks"]:
        raise AssertionError(f"sanitized phase 5: {san}")
    eng.alloc.check_invariants(drained=True)
    log(f"  phase 5's workload, overlap on, sanitized: {san}; streams equal "
        f"phase 5's; TPOT p50 {m['p50_tpot_s'] * 1e3:.2f} / p99 "
        f"{m['p99_tpot_s'] * 1e3:.2f} ms  wall {wall:.3f}s  [{card}]")
    out["phase5"] = dict(san, p50_tpot_s=m["p50_tpot_s"],
                         p99_tpot_s=m["p99_tpot_s"], wall=wall)
    del eng, model, params
    torch.cuda.empty_cache()
    guard = san_lib.Sanitizer()
    x = torch.ones((4,), device=dev)
    tripped = None
    try:
        with guard.no_host_sync("control"):
            x.sum().item()
    except (san_lib.SanitizeError, RuntimeError) as e:
        tripped = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    if tripped is None:
        raise AssertionError("a device read inside no_host_sync passed")
    try:
        with guard.no_host_sync("control"):
            san_lib.host_read(x, reason="not-allowlisted")
    except san_lib.SanitizeError as e:
        tripped_read = str(e)
    else:
        raise AssertionError("a host_read of no allowlisted reason passed")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("the sync debug mode was not restored")
    log(f"  control: .item() inside no_host_sync raised {tripped}; a "
        f"non-allowlisted host_read raised SanitizeError ({tripped_read}); "
        "the sync debug mode is back to 0")
    out["control"] = tripped
    return out


def moe_phase(torch, np, cfg_mod, engine_mod, api, counted, build_model,
              prompts, dev, card):
    """Phase 34: MoE serving: reduced granite-moe and qwen3-moe card
    against CPU, then granite-moe-1b-a400m at full width through B1, B2
    and B3."""
    from repro_torch.layers.moe import moe_apply

    out = {}
    for arch in ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b"):
        reference_check(torch, np, cfg_mod, build_model, engine_mod,
                        arch=arch)
    cfg = cfg_mod.get_config("granite-moe-1b-a400m")
    a = cfg.attention
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  granite-moe-1b-a400m: params {n_params / 1e9:.3f} B "
        f"({n_params * 2 / 1e9:.2f} GB bf16), {cfg.num_layers} layers, d "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
        f"H {a.num_heads} KV {a.num_kv_heads} hd {a.head_dim} G "
        f"{a.num_heads // a.num_kv_heads}; init "
        f"{time.perf_counter() - t0:.1f}s, peak device memory after init "
        f"{peak:.2f} GiB")
    out.update(params=n_params, init_peak_gib=peak)
    log("== 34b. granite-moe-1b-a400m: phase 5's requests, ragged (B1)")
    streams, out["ragged"], launches, cap = serve_at_width(
        torch, np, cfg_mod, engine_mod, api, counted, model, params, cfg,
        prompts, "ragged", dev, card)
    out["ragged"]["launches"] = launches
    out["ragged"]["kernel"] = llama_kernel_steps(
        torch, np, api, cap, "ragged", card, label="granite-moe")
    lanes = {k: cap.got[k][0][0].shape[0] for k in ("decode", "mixed")}
    del cap
    serve = cfg_mod.ServeConfig(model=cfg.name, kv_block_size=SERVE_BS,
                                max_batch=SERVE_BATCH)
    prof = profile_decode(torch, np, model, params, cfg, serve, engine_mod,
                          dev)
    log(f"  decode-only steps: busy share {prof['busy_share']:.1%} of "
        f"{prof['wall_ms']:.3f} ms/step, {prof['launches']:.0f} "
        f"cudaLaunchKernel / step  [{card}]")
    out["decode_profile"] = {k: prof[k] for k in
                             ("wall_ms", "busy_ms", "busy_share", "launches")}
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    moe_ms = {}
    for kind, T in lanes.items():
        h = torch.randn((T, 1, cfg.d_model), generator=gen, device=dev,
                        dtype=model.dtype)

        def layer():
            return moe_apply(lp, h, cfg.moe, full_capacity=True)

        wall = device_ms(layer, device=dev, reps=10)
        busy = busy_ms(torch, layer)
        moe_ms[kind] = dict(lanes=T, layer_device_ms=busy,
                            step_device_ms=busy * cfg.num_layers,
                            layer_events_ms=wall)
        log(f"  MoE layer at full capacity, {kind} step ({T} lanes): device "
            f"{busy:.4f} ms a layer (profiler, the kernels' sum), "
            f"{busy * cfg.num_layers:.3f} ms a step of {cfg.num_layers} "
            f"layers; back-to-back calls {wall:.4f} ms a layer (CUDA "
            f"events: the host's enqueue where it is slower)  [{card}]")
    out["moe_ms"] = moe_ms
    log("== 34c. granite-moe-1b-a400m: the same requests, chunked (B2)")
    c_streams, out["chunked"], c_launches, c_cap = serve_at_width(
        torch, np, cfg_mod, engine_mod, api, counted, model, params, cfg,
        prompts, "chunked", dev, card)
    if c_streams != streams:
        diff = [i for i in streams if c_streams.get(i) != streams[i]]
        raise AssertionError(f"granite chunked greedy streams differ from "
                             f"ragged for requests {diff}")
    log(f"  greedy streams identical to the ragged run ({len(streams)} "
        f"requests x {SERVE_NEW} tokens)")
    out["chunked"]["launches"] = c_launches
    out["chunked"]["kernel"] = llama_kernel_steps(
        torch, np, api, c_cap, "chunked", card, label="granite-moe")
    del c_cap
    log("== 34d. granite-moe-1b-a400m: decode_step_paged (B3)")
    d_launches, d_cap = paper_path(torch, np, api, counted, model, params,
                                   cfg, dev)
    inputs, kw, out_run = d_cap["decode"]
    out["decode"] = kernel_times(
        torch, api.paged_attention_op, inputs, kw, out_run,
        decode_bound(torch, inputs),
        f"granite-moe decode_step_paged last step B={inputs[0].shape[0]} "
        f"H={inputs[0].shape[1]} hd={inputs[0].shape[2]}", card)
    out["decode"].update(launches=d_launches,
                         ms_per_step=d_cap["ms_per_step"])
    log(f"  {d_cap['ms_per_step']:.2f} ms/step  [{card}]")
    del d_cap, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def backward_check(torch, cfg, emb_api, dev):
    """Phase 35: the backward kernel against its plain version on phase 8's
    ids over the config's whole table (T x 1 M rows): uniform ids, the
    last table's top 1000 rows, global id -1 (its row is the last) and an
    id past the end (it adds nothing).  float32 atol 1e-5: float atomics
    add in no fixed order (never bitwise).  Returns the largest error."""
    T, R, D, L = (cfg.num_tables, cfg.num_embeddings, cfg.embedding_dim,
                  cfg.gathers_per_table)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    idx = torch.randint(0, R, (EMB_BATCH, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:64, T - 1] = torch.randint(R - 1000, R, (64, L), generator=gen,
                                    device=dev, dtype=torch.int32)
    idx[64, 0, 0] = -1                 # global -1: the table's last row
    idx[65, T - 1, L - 1] = R          # global T*R: past the end
    offs = torch.arange(T, dtype=torch.int32, device=dev) * R
    gids = (idx + offs[None, :, None]).reshape(-1)
    go = torch.randn((EMB_BATCH, T, D), generator=gen, device=dev)
    got = emb_api.embedding_bag_backward(go, gids, T * R)
    torch.cuda.synchronize()
    want = emb_api.batched_table_backward(go, gids, T * R)
    err = compare(torch, got, want, 1e-5,
                  f"{cfg.name} backward, table {T * R}x{D} "
                  f"({T * R * D * 4 / 2 ** 30:.2f} GiB) bags {EMB_BATCH}x{T} "
                  f"L={L}, a wrapped id and one past the end")
    if not torch.any(got[T * R - 1] != 0):
        raise AssertionError(f"{cfg.name}: the wrapped id's row got nothing")
    del got, want
    return err


def backward_times(torch, cfg, build_model, emb_api, dev, card):
    """Phase 35, times on the main path's B = 4096 inputs (phase 38's
    seeded weights and first batch): the kernel through its C entry point
    (back-to-back launches into one gradient), the plain version (its own
    zeroing included), ``F.embedding_bag``'s backward (the yardstick, its
    own zeroing included; never used by the port), the dense gradient's
    zeroing alone, and the bound."""
    import torch.nn.functional as F

    from repro_torch.data.pipeline import SyntheticRecSysDataset

    params = build_model(cfg, device=dev).init(0)
    table, offs = params["embedding"], params["table_offsets"]
    idx = torch.from_numpy(SyntheticRecSysDataset(cfg, EMB_BATCH).batch_at(
        0)["indices"]).to(dev)
    B, T, L = idx.shape
    R, D = table.shape
    gids = (idx + offs[None, :, None]).reshape(-1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    go = torch.randn((B, T, D), generator=gen, device=dev)
    op = emb_api.embedding_bag_backward
    ms = kernel_ms(op, go, gids, R, device=dev)
    got = op(go, gids, R)
    want = emb_api.batched_table_backward(go, gids, R)
    err = compare(torch, got, want, 1e-5,
                  f"{cfg.name} backward B={B} (main-path inputs)")
    plain_ms = device_ms(lambda: emb_api.batched_table_backward(go, gids, R),
                         device=dev, reps=5)
    zero_ms = device_ms(got.zero_, device=dev)
    del got
    weight = table.detach().requires_grad_(True)
    lib_out = F.embedding_bag(gids.view(-1, L), weight, mode="sum")
    lib_grad = torch.autograd.grad(lib_out, [weight], go.view(-1, D),
                                   retain_graph=True)[0]
    compare(torch, lib_grad, want, 1e-5,
            f"{cfg.name} F.embedding_bag backward (yardstick) vs plain")
    del lib_grad, want
    library_ms = device_ms(lambda: torch.autograd.grad(
        lib_out, [weight], go.view(-1, D), retain_graph=True), device=dev,
        reps=10)
    rows = torch.unique(gids).numel()
    nbytes = go.numel() * 4 + gids.numel() * 4 + 2 * rows * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = B * T * L * D / PEAK_OPS["torch.float32"]
    bound_ms = 1e3 * max(t_bytes, t_ops)
    zero_bound = 1e3 * R * D * 4 / HBM_BYTES_PER_S
    log(f"  {cfg.name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"F.embedding_bag backward {library_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms ({rows} distinct rows of {gids.numel()} ids, "
        f"{nbytes / 1e6:.1f} MB) -> {bound_ms / ms:.1%} of bound  [{card}]")
    log(f"  {cfg.name}: zeroing the dense gradient ({R}x{D} f32, "
        f"{R * D * 4 / 1e9:.2f} GB) {zero_ms:.4f} ms, bound "
        f"{zero_bound:.4f} ms; kernel + zeroing {ms + zero_ms:.4f} ms")
    del params, table, weight, lib_out
    gc.collect()
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, zero_ms=zero_ms,
                zero_bound_ms=zero_bound, distinct_rows=rows)


def backward_ptxas(build, builds, card):
    """Phase 35: every ``embedding_bag_backward_kernel`` instance's
    registers, shared memory and spills (``-Xptxas -v``); a spill fails."""
    rows = [r for r in build.ptxas_report(builds[EMB_KERNEL]["log"])
            if "embedding_bag_backward_kernel" in r["entry"]]
    if not rows:
        raise AssertionError("no embedding_bag_backward_kernel in the "
                             "build's ptxas log")
    out = []
    for r in rows:
        g = re.search(r"ILi(\d+)ELi(\d+)E", r["entry"])
        name = f"G={g.group(1)} NV={g.group(2)}" if g else r["entry"]
        log(f"  backward {name}: {r.get('registers')} registers, "
            f"{r.get('smem')} B smem, stack {r.get('stack')}, spills "
            f"{r.get('spill_stores')}/{r.get('spill_loads')}  [{card}]")
        out.append(dict(instance=name, registers=r.get("registers"),
                        spill_stores=r.get("spill_stores"),
                        spill_loads=r.get("spill_loads")))
        if r.get("spill_stores") or r.get("spill_loads"):
            raise AssertionError(f"backward {name} spills")
    return out


def training_reference_check(torch, cfg_mod, build_model, dev):
    """Phase 36: reduced smollm-360m (f32, 2 layers) and rm2 at 4096 rows a
    table (f32), the same parameters on the card and the CPU, 5 steps of
    ``make_train_step`` with AdamW and ``cosine_warmup`` (TF32 off): per
    step loss rtol 1e-4, grad_norm rtol 1e-3, lr rtol 1e-6; the parameters
    after the last step atol 2e-4 (a fifth of one lr-sized Adam step: Adam
    normalises each element's step, so an element whose gradient is near 0
    turns a rounding difference of the card's sums into a visible one)."""
    import dataclasses

    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import (SyntheticLMDataset,
                                           SyntheticRecSysDataset)
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.training.train_step import TrainState, make_train_step

    lm = cfg_mod.get_config("smollm-360m").reduced(dtype="float32")
    rm = dataclasses.replace(cfg_mod.get_config("rm2"), num_embeddings=4096)
    cases = ((lm, SyntheticLMDataset(lm.vocab_size, 64, 4), {}),
             (rm, SyntheticRecSysDataset(rm, 256), {"weight_decay": 0.0}))
    out = {}
    for cfg, ds, opt_kw in cases:
        params_cpu = build_model(cfg, device="cpu").init(0)
        runs = {}
        for d in ("cpu", dev):
            model = build_model(cfg, device=d)
            params = to_device(params_cpu, d)
            opt = adamw(**opt_kw)
            state = TrainState(params, opt.init(params), torch.zeros(
                (), dtype=torch.int32, device=d))
            step = make_train_step(model, opt, cosine_warmup(1e-3, 2, 5))
            metrics = []
            for i in range(5):
                batch = {k: torch.from_numpy(v).to(d)
                         for k, v in ds.batch_at(i).items()}
                state, m = step(state, batch)
                metrics.append({k: float(v) for k, v in m.items()})
            runs[str(d)] = (metrics, tree_lib.leaves(state.params))
        (m_cpu, p_cpu), (m_dev, p_dev) = runs["cpu"], runs[str(dev)]
        for i, (a, b) in enumerate(zip(m_dev, m_cpu)):
            for key, rtol in (("loss", 1e-4), ("grad_norm", 1e-3),
                              ("lr", 1e-6)):
                if not abs(a[key] - b[key]) <= rtol * abs(b[key]):
                    raise AssertionError(
                        f"{cfg.name} step {i}: {key} card {a[key]!r} CPU "
                        f"{b[key]!r} (rtol {rtol:g})")
        err = max((x.cpu().float() - y.float()).abs().max().item()
                  for x, y in zip(p_dev, p_cpu) if x.numel())
        log(f"  {cfg.name}: 5 steps, loss card / CPU "
            + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}"
                        for a, b in zip(m_dev, m_cpu))
            + f"; grad_norm step 5 {m_dev[-1]['grad_norm']:.6f}/"
            f"{m_cpu[-1]['grad_norm']:.6f}; params max_abs_err {err:.3e} "
            f"(atol 2e-4)")
        if not err <= 2e-4:
            raise AssertionError(f"{cfg.name}: params after 5 steps differ "
                                 f"by {err}")
        out[cfg.name] = dict(losses=[a["loss"] for a in m_dev],
                             params_max_abs_err=err)
    return out


def lm_training(torch, cfg_mod, build_model, counted, dev, card):
    """Phase 37: smollm-360m at full width in float32 (32 layers, d 960,
    remat ``full``) through the launcher's pieces (``launch/train.py``):
    AdamW, ``cosine_warmup(3e-4, 1, 10)``, ``SyntheticLMDataset`` batches
    of 8 x 256 through ``DataPipeline``, ``Trainer`` and a
    ``CheckpointManager`` that saves step 5.  A fresh trainer (other seed)
    restores step 5 and runs to step 10: its losses equal the uninterrupted
    run's (rtol 1e-5).  The LM path runs none of the port's kernels (its
    attention is the reference's plain chunked attention): every launch
    count stays 0."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataPipeline, SyntheticLMDataset
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.training.train_step import init_state, make_train_step
    from repro_torch.training.trainer import Trainer

    cfg = dataclasses.replace(cfg_mod.get_config("smollm-360m"),
                              dtype="float32")
    model = build_model(cfg, device=dev, remat="full")
    opt = adamw()
    step = make_train_step(model, opt, cosine_warmup(
        3e-4, max(TRAIN_STEPS // 10, 1), TRAIN_STEPS))
    ds = SyntheticLMDataset(cfg.vocab_size, LM_SEQ, LM_BATCH)
    half = TRAIN_STEPS // 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(model, 0, opt)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  smollm-360m f32: {cfg.num_params() / 1e6:.1f} M params; init "
        f"peak (params, m, v) {init_peak:.2f} GiB")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cm = CheckpointManager(ckpt_dir, keep=1)
        pipe = DataPipeline(ds)
        whole = Trainer(step_fn=step, state=state, pipeline=pipe, ckpt=cm,
                        checkpoint_every=half)
        reset_counts(counted)
        t0 = time.perf_counter()
        whole.run(half)                  # saves step 5 and waits for it
        t_ckpt = time.perf_counter()
        whole.checkpoint_every = 0
        whole.run(TRAIN_STEPS - half)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipe.close()
        launched = sum(op.launches for op in counted)
        if cm.all_steps() != [half]:
            raise AssertionError(f"checkpoints {cm.all_steps()} != [{half}]")
        t1 = time.perf_counter()
        pipe2 = DataPipeline(ds, start_step=half)
        again = Trainer(step_fn=step, state=init_state(model, 1, opt),
                        pipeline=pipe2, ckpt=cm, checkpoint_every=0)
        if again.maybe_restore() != half:
            raise AssertionError("the restore did not find step 5")
        restore_s = time.perf_counter() - t1
        again.run(TRAIN_STEPS - half)
        pipe2.close()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = whole.history
    for h in hist:
        log(f"    step {h['step']:2d}  loss {h['loss']:.6f}  grad_norm "
            f"{h['grad_norm']:.4f}  {h['dt'] * 1e3:.1f} ms")
    resumed = [h["loss"] for h in again.history]
    want = [h["loss"] for h in hist[half:]]
    log(f"  restored at step {half} ({restore_s:.1f} s with a fresh init): "
        f"losses {', '.join(f'{x:.6f}' for x in resumed)}")
    if not all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(resumed, want)):
        raise AssertionError(f"restored losses {resumed} != {want}")
    if not all(map(lambda x: x == x and abs(x) < 1e9,
                   [h["loss"] for h in hist + again.history])):
        raise AssertionError("a loss is not finite")
    if launched:
        raise AssertionError(f"{launched} kernel launches on the LM path")
    p50 = percentile([h["dt"] for h in hist[1:]], 50)
    tokens = LM_BATCH * LM_SEQ
    log(f"  {TRAIN_STEPS} steps + a checkpoint in {wall:.1f} s (first "
        f"{half} steps and the save {t_ckpt - t0:.1f} s); step p50 "
        f"{p50 * 1e3:.1f} ms, {tokens / p50:.0f} tokens/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"kernel launches {launched}  [{card}]")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             ds.batch_at(0).items()}
    holder = [again.state]

    def one():
        holder[0], _ = step(holder[0], batch)

    one()
    prof = profile_calls(torch, one, 2, "train steps", "step")
    del whole, again, holder, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(init_peak_gib=init_peak, step_ms_p50=p50 * 1e3,
                tokens_per_s=tokens / p50, busy_share=prof["busy_share"],
                busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                launches_per_step=prof["launches"],
                losses=[h["loss"] for h in hist], restored_losses=resumed)


def dlrm_training(torch, cfg_mod, build_model, emb_api, counted, dev, card):
    """Phase 38: rm1 and rm2 at 1 M rows a table, float32, B = 4096,
    ``adamw(weight_decay=0.0)`` at lr 1e-3, 10 steps of
    ``make_train_step`` through the ``Trainer`` over ``DataPipeline``
    batches: B4's forward and backward launch once a step each, every
    loss is finite.  Then a profiled step (busy share, launches, the
    backward kernel's device ms) and the device ms of the forward (with
    its graph) and of the optimizer's update, each under the profiler."""
    from repro_torch import tree as tree_lib
    from repro_torch.data.pipeline import DataPipeline, SyntheticRecSysDataset
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizer import apply_updates
    from repro_torch.optim.schedules import constant
    from repro_torch.training.train_step import (
        init_state, loss_and_grads, make_train_step)
    from repro_torch.training.trainer import Trainer

    out, launches = {}, 0
    for arch in ("rm1", "rm2"):
        cfg = cfg_mod.get_config(arch)
        model = build_model(cfg, device=dev)
        opt = adamw(weight_decay=0.0)
        lr_fn = constant(1e-3)
        step = make_train_step(model, opt, lr_fn)
        state = init_state(model, 0, opt)
        pipe = DataPipeline(SyntheticRecSysDataset(cfg, EMB_BATCH))
        trainer = Trainer(step_fn=step, state=state, pipeline=pipe)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counted)
        trainer.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        fwd = emb_api.embedding_bag.launches
        bwd = emb_api.embedding_bag_backward.launches
        pipe.close()
        launches += bwd
        losses = [h["loss"] for h in trainer.history]
        p50 = percentile([h["dt"] for h in trainer.history[1:]], 50)
        log(f"  {arch}: {TRAIN_STEPS} steps, losses "
            + ", ".join(f"{x:.5f}" for x in losses)
            + f"; step p50 {p50 * 1e3:.2f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; B4 "
            f"forward launches {fwd}, backward launches {bwd}  [{card}]")
        if fwd != TRAIN_STEPS or bwd != TRAIN_STEPS:
            raise AssertionError(f"{arch}: B4 launches forward {fwd} / "
                                 f"backward {bwd} != steps {TRAIN_STEPS}")
        if not all(x == x and abs(x) < 1e9 for x in losses):
            raise AssertionError(f"{arch}: a loss is not finite: {losses}")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 SyntheticRecSysDataset(cfg, EMB_BATCH).batch_at(0).items()}
        holder = [trainer.state]

        def one():
            holder[0], _ = step(holder[0], batch)

        prof = profile_calls(torch, one, 2, f"{arch} train steps", "step")
        by_kernel = prof["device_ms"]
        bwd_ms = sum(v for k, v in by_kernel.items()
                     if "embedding_bag_backward_kernel" in k)
        fwd_kernel_ms = sum(v for k, v in by_kernel.items()
                            if "embedding_bag_kernel" in k)
        params = holder[0].params

        def forward():
            with torch.enable_grad():
                xs = tree_lib.map(lambda p: p.detach().requires_grad_(True)
                                  if p.is_floating_point() else p, params)
                model.loss(xs, batch)

        forward_ms = busy_ms(torch, forward, n=3)
        _, grads = loss_and_grads(model.loss, params, batch)
        opt_state = holder[0].opt
        lr = lr_fn(holder[0].step)

        def optimizer():
            updates, _, _ = opt.update(grads, opt_state, params, lr)
            apply_updates(params, updates)

        optimizer_ms = busy_ms(torch, optimizer, n=2)
        log(f"  {arch} one step's device ms: forward (with its graph) "
            f"{forward_ms:.3f} (B4 forward {fwd_kernel_ms:.4f}), backward "
            f"kernel {bwd_ms:.4f}, optimizer (AdamW + apply) "
            f"{optimizer_ms:.3f}; the step busy {prof['busy_ms']:.3f} of "
            f"{prof['wall_ms']:.3f} ms ({prof['busy_share']:.1%})  [{card}]")
        out[arch] = dict(step_ms_p50=p50 * 1e3, losses=losses,
                         busy_share=prof["busy_share"],
                         busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                         launches_per_step=prof["launches"],
                         forward_ms=forward_ms, b4_forward_ms=fwd_kernel_ms,
                         backward_kernel_ms=bwd_ms,
                         optimizer_ms=optimizer_ms, b4_launches=fwd,
                         b4_backward_launches=bwd)
        del trainer, state, holder, params, grads, opt_state, model
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


FAMILIES = ["rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny", "internvl2-26b"]
FAM_BATCH, FAM_PROMPT, FAM_TEACHER, FAM_GREEDY = 8, 512, 64, 32
FAM_MAX_SEQ = 128          # the contiguous caches: 64 + 32 + 4 steps fit
FAM_TRAIN_STEPS, FAM_TRAIN_SEQ = 5, 256


def family_inputs(np, cfg, batch, seq, seed):
    """Seeded tokens (batch, seq) and the family's stub embeddings: the
    VLM's vision tokens at the embedding table's scale, whisper's encoder
    frames (unit normal), else None."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    extra = None
    if cfg.family == "vlm":
        extra = (rng.standard_normal((batch, cfg.vision_tokens, cfg.d_model))
                 * cfg.d_model ** -0.5).astype(np.float32)
    elif cfg.family == "audio":
        extra = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)
                                    ).astype(np.float32)
    return tokens, extra


def family_cache(model, cfg, params, batch, frames):
    """A zeroed contiguous decode cache of ``batch`` requests; whisper's
    cross-attention K/V filled from ``frames``."""
    cache = model.init_decode_cache(batch, FAM_MAX_SEQ)
    if cfg.family == "audio":
        cache = model.prefill_cross(params, cache, frames)
    return cache


def families_reference_check(torch, np, cfg_mod, build_model, dev):
    """Phase 39: each family reduced in float32 (zamba2 at 4 layers, two
    groups), one seeded init on the CPU copied to the card (TF32 off):
    forward logits atol 1e-4, 8 ``decode_step`` logits (whisper after
    ``prefill_cross``) atol 1e-4, the loss rtol 1e-5 and every gradient
    leaf atol 1e-4 (+ rtol 1e-4) between the card and the CPU."""
    from repro_torch import tree as tree_lib
    from repro_torch.training.train_step import loss_and_grads

    out = {}
    for arch in FAMILIES:
        over = {"num_layers": 4} if arch == "zamba2-2.7b" else {}
        cfg = cfg_mod.get_config(arch).reduced(dtype="float32", **over)
        tokens, extra = family_inputs(np, cfg, 2, 64, seed=39)
        params_cpu = build_model(cfg, device="cpu").init(0)
        runs = {}
        for d in ("cpu", dev):
            model = build_model(cfg, device=d, remat="none")
            params = to_device(params_cpu, d)
            batch = {"tokens": torch.from_numpy(tokens).to(d)}
            if extra is not None:
                batch["extra_embeds"] = torch.from_numpy(extra).to(d)
            with torch.no_grad():
                logits, _ = model.forward(params, batch["tokens"],
                                          batch.get("extra_embeds"))
                cache = family_cache(model, cfg, params, 2,
                                     batch.get("extra_embeds"))
                steps = []
                for t in range(8):
                    lg, cache = model.decode_step(params, cache,
                                                  batch["tokens"][:, t])
                    steps.append(lg)
            loss, grads = loss_and_grads(model.loss, params, batch)
            runs[str(d)] = (logits.cpu(), torch.stack(steps, 1).cpu(),
                            float(loss),
                            [g.cpu() for g in tree_lib.leaves(grads)])
        (lc, dc, loss_c, gc_), (ld, dd, loss_d, gd) = (runs["cpu"],
                                                        runs[str(dev)])
        errs = dict(forward=(ld - lc).abs().max().item(),
                    decode=(dd - dc).abs().max().item(),
                    loss_rel=abs(loss_d - loss_c) / abs(loss_c),
                    grads=max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                              for a, b in zip(gd, gc_)))
        log(f"  {arch} reduced f32: forward {errs['forward']:.2e} (atol "
            f"1e-4), decode x8 {errs['decode']:.2e} (atol 1e-4), loss "
            f"{loss_d:.6f}/{loss_c:.6f} rel {errs['loss_rel']:.1e} (rtol "
            f"1e-5), {len(gd)} gradient leaves: max(|diff| - 1e-4 |CPU|) "
            f"{errs['grads']:.2e} (atol 1e-4)")
        if not (errs["forward"] <= 1e-4 and errs["decode"] <= 1e-4
                and errs["loss_rel"] <= 1e-5 and errs["grads"] <= 1e-4):
            raise AssertionError(f"{arch}: card against CPU {errs}")
        out[arch] = errs
    return out


def decode_step_bytes(cfg, params, cache, batch, pos):
    """The bytes one decode step at position ``pos`` must move: every
    weight it reads once (the embedding table only for its ``batch``
    gathered rows; whisper's encoder not at all), the contiguous K/V up to
    ``pos`` read and one position written, the recurrent states read and
    written, whisper's cross K/V read.  Returns (weight bytes, cache
    bytes)."""
    from repro_torch import tree as tree_lib

    skip = {"embed", "enc_layers", "enc_norm"}
    weights = sum(x.numel() * x.element_size() for k, v in params.items()
                  if k not in skip for x in tree_lib.leaves(v))
    table = params["embed"]["table"]
    weights += batch * table.shape[1] * table.element_size()
    state = 0
    for k, v in cache.items():
        nbytes = v.numel() * v.element_size()
        if k in ("k", "v"):
            state += nbytes * (pos + 2) // FAM_MAX_SEQ
        elif k in ("xk", "xv"):
            state += nbytes
        elif k != "seq_lens":
            state += 2 * nbytes
    return weights, state


def forward_f32(torch, build_model, cfg, params, toks, frames, dev):
    """The model's ``forward`` logits in float32 on the bf16 ``params``
    widened.  internvl2-26b's float32 weights (80 GB) do not fit beside
    its bf16 ones, so its layers are widened one at a time through the
    float32 model's own block."""
    import dataclasses

    from repro_torch import tree as tree_lib
    from repro_torch.layers.embedding import embed, unembed
    from repro_torch.layers.norm import rmsnorm
    from repro_torch.models import stacking

    def f32(tree):
        return tree_lib.map(lambda t: t.float(), tree)

    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    if cfg.family != "vlm":
        return m32.forward(f32(params), toks, frames)[0]
    x = embed(params["embed"], toks).float()
    B, S = toks.shape
    positions = torch.arange(S, device=dev).expand(B, S)
    for i in range(cfg.num_layers):
        x = m32._block(f32(stacking.layer(params["layers"], i)), x,
                       positions)[0]
    x = rmsnorm(f32(params["final_norm"]), x, cfg.norm_eps)
    return unembed(f32(params.get("head", params["embed"])), x)


def teacher_forced_check(torch, build_model, cfg, params, toks, frames, full,
                         dec, dev):
    """Phase 40's check of the bf16 decode (logits ``dec``, B x T x V, fed
    the prompts' first T tokens) against the bf16 ``forward``'s logits
    ``full`` over the same tokens.

    The two round apart in bf16 by more than phase 30's two ulps of a
    logit: rwkv6 and zamba2 decode through another algorithm (the
    recurrence against the chunked scan), and a one-position decode runs
    other GEMMs than a 64-position forward, whose roundings 48 layers of
    internvl2 carry to a 3-ulp flip (first chip run of this phase).  So
    both are held to a float32 forward on the same weights: the decode's
    largest logit error must be at most twice the bf16 forward's.  Where
    the decode's argmax leaves the bf16 forward's, the forward's top-2
    gap is printed in bf16 ulps."""
    top2 = full.topk(2, dim=-1).values
    flips = (dec.argmax(-1) != full.argmax(-1)).nonzero().tolist()
    gaps = [round((float(top2[b, t, 0]) - float(top2[b, t, 1]))
                  / bf16_ulp(float(top2[b, t, 0])), 3) for b, t in flips]
    oracle = forward_f32(torch, build_model, cfg, params, toks, frames, dev)
    e_fwd = (full - oracle).abs().max().item()
    e_dec = (dec - oracle).abs().max().item()
    out = dict(positions=int(dec.shape[0] * dec.shape[1]),
               max_abs_forward_vs_f32=e_fwd, max_abs_decode_vs_f32=e_dec,
               forward_parted_from_f32=int(
                   (full.argmax(-1) != oracle.argmax(-1)).sum()),
               decode_parted_from_f32=int(
                   (dec.argmax(-1) != oracle.argmax(-1)).sum()),
               max_abs_decode_vs_forward=(dec - full).abs().max().item(),
               decode_parted_from_forward=len(flips),
               parted_gap_ulps=gaps)
    log(f"  {cfg.name}: teacher-forced {out['positions']} positions; "
        f"against a float32 forward on the same weights the bf16 forward "
        f"is {e_fwd:.4f} off ({out['forward_parted_from_f32']} argmax "
        f"parted), the bf16 decode {e_dec:.4f} "
        f"({out['decode_parted_from_f32']} parted; at most twice the "
        f"forward's); decode against the bf16 forward: max "
        f"{out['max_abs_decode_vs_forward']:.4f}, {len(flips)} argmax "
        f"parted at the forward's top-2 gaps {gaps} bf16 ulps")
    if not e_dec <= 2 * e_fwd:
        raise AssertionError(f"{cfg.name}: the bf16 decode is {e_dec} from "
                             f"float32, the bf16 forward {e_fwd}")
    return out


def family_serving(torch, np, cfg_mod, build_model, counted, arch, dev,
                   card):
    """Phase 40, one config at full width in bf16 with seeded weights:
    the init's peak; ``make_prefill_step`` on 8 prompts of 512 tokens (the
    VLM's 256 vision-stub embeddings before them, whisper's 1500 frames
    beside them), timed on its second call; the prompts' first 64 tokens
    teacher-forced through ``decode_step`` (what ``make_serve_step``
    takes its argmax of) against a full-logits ``forward`` over the same
    64 tokens (:func:`teacher_forced_check`); 32 greedy tokens through
    ``make_serve_step``, each step timed; three decode steps under
    torch.profiler; the step's byte bound.  No kernel of the port may
    launch."""
    from repro_torch import tree as tree_lib
    from repro_torch.serving.steps import make_prefill_step, make_serve_step

    cfg = cfg_mod.get_config(arch)
    B, T, G = FAM_BATCH, FAM_TEACHER, FAM_GREEDY
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    log(f"  {arch}: {n_params / 1e9:.3f} B parameters "
        f"({cfg.num_params() / 1e9:.3f} B by num_params), init peak "
        f"{init_peak:.2f} GiB (held before {held:.2f} GiB)")
    tokens, extra = family_inputs(np, cfg, B, FAM_PROMPT, seed=40)
    toks = torch.from_numpy(tokens).to(dev)
    batch = {"tokens": toks}
    if extra is not None:
        batch["extra_embeds"] = torch.from_numpy(extra).to(dev)
    frames = batch["extra_embeds"] if cfg.family == "audio" else None
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    reset_counts(counted)
    with torch.no_grad():
        prefill_s = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = prefill(params, batch)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        if last.shape != (B, cfg.vocab_size) or not torch.isfinite(
                last).all():
            raise AssertionError(f"{arch}: prefill logits {last.shape}")
        full, _ = model.forward(params, toks[:, :T], frames)
        cache = family_cache(model, cfg, params, B, frames)
        dec = []
        for t in range(T):
            lg, cache = model.decode_step(params, cache, toks[:, t])
            dec.append(lg)
        dec = torch.stack(dec, 1)
        teacher = teacher_forced_check(torch, build_model, cfg, params,
                                       toks[:, :T], frames, full, dec, dev)
        got = dec.argmax(-1).to(torch.int32)
        del full, dec
        tok, step_s, stream = got[:, -1], [], []
        for _ in range(G):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok, cache = serve(params, cache, tok)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            stream.append(tok)
        stream = torch.stack(stream, 1)
        if not bool(((stream >= 0) & (stream < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch}: a greedy token out of range")
        pos = int(cache["seq_lens"][0])
        w_bytes, s_bytes = decode_step_bytes(cfg, params, cache, B, pos)
        holder = [tok]

        def one():
            holder[0], _ = serve(params, cache, holder[0])

        prof = profile_calls(torch, one, 3, f"{arch} decode steps", "step")
    launched = sum(op.launches for op in counted)
    if launched:
        raise AssertionError(f"{arch}: {launched} kernel launches")
    p50 = percentile(step_s, 50)
    weights_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    bound = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"  {arch}: prefill {B} x {FAM_PROMPT} "
        f"{prefill_s[1] * 1e3:.2f} ms (first call {prefill_s[0] * 1e3:.2f}); "
        f"decode p50 {p50 * 1e3:.3f} ms a step, {B / p50:.1f} tokens/s; "
        f"byte bound {bound:.4f} ms (weights {w_bytes / 1e9:.3f} GB "
        f"{weights_ms:.4f} ms + cache {s_bytes / 1e6:.2f} MB), "
        f"{bound / (p50 * 1e3):.1%} of the step  [{card}]")
    del model, params, cache, holder, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(params_b=n_params / 1e9, init_peak_gib=init_peak,
                prefill_ms=prefill_s[1] * 1e3,
                prefill_first_ms=prefill_s[0] * 1e3,
                teacher_forced=teacher, decode_ms_p50=p50 * 1e3,
                tokens_per_s=B / p50, busy_share=prof["busy_share"],
                busy_ms=prof["busy_ms"], wall_ms=prof["wall_ms"],
                launches_per_step=prof["launches"],
                weights_bound_ms=weights_ms, bound_ms=bound,
                bound_by="bytes", greedy_head=stream[0, :8].tolist())


def launcher_training(torch, counted, arch, batch, card):
    """Phase 41 through the launcher: ``repro_torch.launch.train.main``
    with ``--arch arch --steps 5 --batch batch --seq 256`` (float32, remat
    ``full``, AdamW) on the card.  The launcher's Trainer is recorded (a
    subclass that calls the original) to read each step's time and to
    profile one more step."""
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch import train as train_launch

    trainers = []

    class Recorded(train_launch.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            trainers.append(self)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counted)
    train_launch.Trainer = Recorded
    try:
        summary = train_launch.main([
            "--arch", arch, "--steps", str(FAM_TRAIN_STEPS), "--batch",
            str(batch), "--seq", str(FAM_TRAIN_SEQ)])
    finally:
        train_launch.Trainer = Recorded.__bases__[0]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = sum(op.launches for op in counted)
    trainer = trainers[0]
    losses = [h["loss"] for h in trainer.history]
    if len(losses) != FAM_TRAIN_STEPS or not all(
            x == x and abs(x) < 1e9 for x in losses):
        raise AssertionError(f"{arch}: losses {losses}")
    if launched:
        raise AssertionError(f"{arch}: {launched} kernel launches")
    vocab = trainer.state.params["embed"]["table"].shape[0]
    data = SyntheticLMDataset(vocab, FAM_TRAIN_SEQ, batch).batch_at(0)
    data = {k: torch.from_numpy(v).to(trainer.device)
            for k, v in data.items()}
    holder = [trainer.state]

    def one():
        holder[0], _ = trainer.step_fn(holder[0], data)

    prof = profile_calls(torch, one, 1, f"{arch} train step", "step")
    p50 = percentile([h["dt"] for h in trainer.history[1:]], 50)
    tokens = batch * FAM_TRAIN_SEQ
    log(f"  {arch} f32 through the launcher, {batch} x {FAM_TRAIN_SEQ}: "
        f"losses {', '.join(f'{x:.5f}' for x in losses)}; step p50 "
        f"{p50 * 1e3:.1f} ms, {tokens / p50:.0f} tokens/s; peak "
        f"{peak:.2f} GiB; summary {summary}  [{card}]")
    del trainers, trainer, holder, data
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=batch, losses=losses, step_ms_p50=p50 * 1e3,
                tokens_per_s=tokens / p50, peak_gib=peak,
                busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
                wall_ms=prof["wall_ms"], launches_per_step=prof["launches"])


def whisper_training(torch, np, cfg_mod, build_model, counted, dev, card):
    """Phase 41, whisper-tiny at full width in float32: ``make_train_step``
    (``loss_and_grads``, AdamW, ``cosine_warmup``) on 8 x 256 tokens and
    1500 seeded stub frames a sample, as the quickstart trains it (the
    launcher's batches hold tokens only, as the reference's)."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.training.train_step import init_state, make_train_step

    cfg = dataclasses.replace(cfg_mod.get_config("whisper-tiny"),
                              dtype="float32")
    B = FAM_BATCH
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev)
    opt = adamw()
    step = make_train_step(model, opt, cosine_warmup(
        3e-4, 1, FAM_TRAIN_STEPS))
    state = init_state(model, 0, opt)
    _, frames = family_inputs(np, cfg, B, 1, seed=41)
    frames = torch.from_numpy(frames).to(dev)
    ds = SyntheticLMDataset(cfg.vocab_size, FAM_TRAIN_SEQ, B)
    reset_counts(counted)
    losses, dts = [], []
    for i in range(FAM_TRAIN_STEPS):
        batch = {"tokens": torch.from_numpy(ds.batch_at(i)["tokens"]).to(
            dev), "extra_embeds": frames}
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        dts.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = sum(op.launches for op in counted)
    if launched or not all(x == x and abs(x) < 1e9 for x in losses):
        raise AssertionError(f"whisper-tiny: losses {losses}, {launched} "
                             "kernel launches")
    holder = [state]

    def one():
        holder[0], _ = step(holder[0], batch)

    prof = profile_calls(torch, one, 1, "whisper-tiny train step", "step")
    p50 = percentile(dts[1:], 50)
    tokens = B * FAM_TRAIN_SEQ
    log(f"  whisper-tiny f32, {B} x {FAM_TRAIN_SEQ} tokens + {B} x "
        f"{cfg.encoder_seq} frames: losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}; step p50 "
        f"{p50 * 1e3:.1f} ms, {tokens / p50:.0f} tokens/s; peak "
        f"{peak:.2f} GiB  [{card}]")
    del model, state, holder
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=B, losses=losses, step_ms_p50=p50 * 1e3,
                tokens_per_s=tokens / p50, peak_gib=peak,
                busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
                wall_ms=prof["wall_ms"], launches_per_step=prof["launches"])


def internvl_training_cpu():
    """Phase 41: internvl2-26b's float32 state (about 318 GB with AdamW)
    does not fit one 80 GB card, so it trains reduced on the CPU through
    the launcher, as the CPU tests do."""
    from repro_torch.launch import train as train_launch

    summary = train_launch.main([
        "--arch", "internvl2-26b", "--reduced", "--device", "cpu",
        "--steps", str(FAM_TRAIN_STEPS), "--batch", "2", "--seq", "32"])
    if not summary["final_loss"] == summary["final_loss"]:
        raise AssertionError(f"internvl2-26b reduced: {summary}")
    log("  internvl2-26b: trained reduced on the CPU only (its f32 weights "
        "and AdamW state, about 318 GB, do not fit one 80 GB card): "
        f"{summary}")
    return dict(reduced_cpu=summary)


# -- phases 42-46: the end-to-end serving figures, the harness's sweeps,
# the step roofline and energy ------------------------------------------------
@contextlib.contextmanager
def bench_env(**env):
    """The benchmark modules' environment switches, set for the block and
    restored after it."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: v for k, v in env.items() if v is not None})
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_vs_cpu_rows(what, card_rows, cpu_rows, fields):
    """The rows of a card run and a CPU run of the same call: the same
    names, and every field that is not a time equal."""
    if [r["name"] for r in card_rows] != [r["name"] for r in cpu_rows]:
        raise AssertionError(f"{what}: rows {[r['name'] for r in card_rows]}"
                             f" != {[r['name'] for r in cpu_rows]}")
    for c, p in zip(card_rows, cpu_rows):
        if fields(c) != fields(p):
            raise AssertionError(f"{what} {c['name']}: card {fields(c)} != "
                                 f"CPU {fields(p)}")


def engine_rows_summary(rows):
    """TTFT / TPOT p50 and p99 and tok/s of the engine rows, by name."""
    keys = ("ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
            "tok_s", "spec_accept", "tok_per_lane", "preempt", "finished",
            "prefix_hit_rate", "prefill_frac", "decode_frac", "preemptions",
            "blocks_allocated", "indep_blocks_allocated", "speedup_vs_indep")
    out = {}
    for r in rows:
        kv = dict(f.split("=", 1) for f in r["derived"].split(";"))
        out[r["name"]] = dict({k: kv[k] for k in keys if k in kv},
                              ms=round(r["ms"], 3))
    return out


def llm_e2e_phase(torch, cfg_mod, build_model, api, counted, model8, params8,
                  dev, card):
    """Phase 42: (a) the smoke scenarios on the reference's model and
    weights under ``off`` and ``ngram``, card against CPU, every field that
    is not a time (nor ``backend``) equal; (b) llama31-8b at full width in
    bf16 with seeded weights at the reference's full sizes, the breakdown
    and every scenario under ``off`` and ``ngram``, through B1."""
    from repro_torch.bench import llm_e2e
    from repro_torch.serving import spec as spec_lib

    out = {"reference": {}, "llama31_8b": {}}
    with bench_env(REPRO_BENCH_SMOKE="1"):
        for proposer in ("off", "ngram"):
            with spec_lib.force_proposer(proposer):
                reset_counts(counted)
                card_rows = llm_e2e.run(dev)
                torch.cuda.synchronize()
                b1 = api.paged_attention_ragged_op.launches
                cpu_rows = llm_e2e.run("cpu")
            card_vs_cpu_rows(f"42a llm_e2e [{proposer}]", card_rows,
                             cpu_rows, llm_e2e.counters)
            if b1 == 0:
                raise AssertionError("42a: B1 never launched")
            out["reference"][proposer] = dict(
                rows=len(card_rows), b1_launches=b1,
                counters={r["name"]: llm_e2e.counters(r) for r in card_rows})
            log(f"  42a [{proposer}]: {len(card_rows)} rows, every counter "
                f"equal to the CPU run's; B1 launches {b1}")
    cfg8 = model8.cfg
    with bench_env(REPRO_BENCH_SMOKE=None):
        for proposer in ("off", "ngram"):
            with spec_lib.force_proposer(proposer):
                reset_counts(counted)
                t0 = time.perf_counter()
                rows = llm_e2e.run(dev, quick=False, cfg=cfg8, params=params8)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = {op.name: op.launches for op in counted
                        if op.launches}
            if launches.get(api.paged_attention_ragged_op.name, 0) == 0:
                raise AssertionError("42b: B1 never launched")
            for r in rows:
                c = llm_e2e.counters(r)
                if "finished" in c and c["finished"] == "0":
                    raise AssertionError(f"42b {r['name']}: none finished")
            summary = engine_rows_summary(rows)
            out["llama31_8b"][proposer] = dict(rows=summary,
                                                launches=launches,
                                                wall_s=round(wall, 1))
            log(f"  42b llama31-8b [{proposer}] ({wall:.1f} s; launches "
                f"{launches}; {card}):")
            for name, s in summary.items():
                log(f"    {name}: {s}")
    return out


def saturation_phase(torch, build_model, api, counted, model8, params8, dev,
                     card):
    """Phase 43: the saturation wave overlap off and on on the reference's
    model (counters equal to the CPU run's) with the B2 sweep at its quick
    sizes, then at llama31-8b's full width in bf16 with the B2 sweep at its
    full sizes; a pass with ``REPRO_SANITIZE=1``."""
    from repro_torch.bench import llm_e2e, saturation

    def counters(r):
        c = llm_e2e.counters(r)
        if r["name"].startswith("llm_saturation"):
            return {k: c[k] for k in saturation.COUNTERS}
        return c

    out = {}
    reset_counts(counted)
    card_rows = saturation.run(dev)
    torch.cuda.synchronize()
    b2 = api.paged_attention_chunked_op.launches
    cpu_rows = saturation.run("cpu")
    card_vs_cpu_rows("43 saturation (reference model)", card_rows, cpu_rows,
                     counters)
    out["reference"] = {r["name"]: dict(counters(r), ms=round(r["ms"], 4))
                        for r in card_rows}
    log(f"  43 reference model: counters equal to the CPU run's; B2 "
        f"launches {b2}")
    reset_counts(counted)
    t0 = time.perf_counter()
    rows = saturation.run(dev, quick=False, cfg=model8.cfg, params=params8)
    torch.cuda.synchronize()
    launches = {op.name: op.launches for op in counted if op.launches}
    for name in (api.paged_attention_ragged_op.name,
                 api.paged_attention_chunked_op.name):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"43 llama31-8b: {name} never launched")
    full = {}
    for r in rows:
        kv = dict(f.split("=", 1) for f in r["derived"].split(";"))
        if r["name"].startswith("llm_saturation"):
            full[r["name"]] = {k: kv[k] for k in ("tok_s", "device_frac",
                                                  "steps", "preempt",
                                                  "finished")}
            log(f"    {r['name']}: tok_s {kv['tok_s']} device_frac "
                f"{kv['device_frac']} steps {kv['steps']} ({card})")
        else:
            full[r["name"]] = dict(ms=r["ms"], max_abs_err=r["max_abs_err"],
                                   page=kv["page"], depth=kv["depth"])
            log(f"    {r['name']}: B2 {r['ms']:.4f} ms, max |err| "
                f"{r['max_abs_err']:.3g}, bits equal across depths "
                f"({card})")
    out["llama31_8b"] = dict(rows=full, launches=launches,
                             wall_s=round(time.perf_counter() - t0, 1))
    reset_counts(counted)
    with bench_env(REPRO_SANITIZE="1"):
        san_rows = saturation.run(dev)
    out["sanitized"] = {r["name"]: counters(r) for r in san_rows
                        if r["name"].startswith("llm_saturation")}
    log(f"  43 sanitized (REPRO_SANITIZE=1): zero retraces and host-sync "
        f"trips, allocator checks run: {out['sanitized']}")
    return out


def harness_phase(torch, card):
    """Phase 44: ``bench.run --only llm_e2e,saturation`` over two policy
    triples and two proposers under ``REPRO_BENCH_SMOKE=1``, in its own
    process: it exits 0, saturation runs once a triple, llm_e2e once a
    (triple, proposer), and every row names what was forced."""
    import subprocess
    import tempfile

    triples = ["fcfs/latest-arrival/lru", "priority/most-blocks/hit-rate"]
    specs = ["off", "ngram"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "sweep.json"
        env = dict(os.environ, REPRO_BENCH_SMOKE="1",
                   PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.bench.run", "--only",
             "llm_e2e,saturation", "--policy", ",".join(triples), "--spec",
             ",".join(specs), "--json", str(path)],
            env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
        if r.returncode != 0:
            raise AssertionError(f"44: bench.run exited {r.returncode}: "
                                 f"{r.stderr[-3000:]}")
        results = json.loads(path.read_text())
    passes = [(x["module"], x["requested_policy"], x["requested_spec"])
              for x in results]
    want = [("llm_e2e", t, s) for t in triples for s in specs]
    want += [("saturation", t, specs[0]) for t in triples]
    if sorted(passes) != sorted(want):
        raise AssertionError(f"44: passes {passes} != {want}")
    # the commit as git gives it to this script: a checkout's HEAD, which
    # the stamp must abbreviate, or none (a copy without .git), where the
    # stamp must say "unknown"
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True, timeout=10)
        head = head.stdout.strip() if head.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        head = ""
    rows = 0
    for x in results:
        for row in x["rows"]:
            rows += 1
            if (row["policy"], row["spec"]) != (x["requested_policy"],
                                                 x["requested_spec"]):
                raise AssertionError(f"44 {x['module']} {row['name']}: "
                                     f"stamped {row['policy']} / "
                                     f"{row['spec']}, forced "
                                     f"{x['requested_policy']} / "
                                     f"{x['requested_spec']}")
            pol = dict(f.split("=", 1) for f in row["derived"].split(";"))
            if "policies" in pol and pol["policies"] != row["policy"]:
                raise AssertionError(f"44 {row['name']}: engine ran "
                                     f"{pol['policies']}")
            if "spec" in pol and pol["spec"] != row["spec"]:
                raise AssertionError(f"44 {row['name']}: engine ran "
                                     f"{pol['spec']}")
        stamped = x["git_commit"]
        if (x["card"] != card or not x["schema_version"]
                or not (head.startswith(stamped) if head
                        else stamped == "unknown")
                or len(stamped) < 7):
            raise AssertionError(f"44: provenance {x['card']!r} "
                                 f"{stamped!r}, git HEAD {head!r}")
    log(f"  44: {len(results)} passes, {rows} rows, each stamped with the "
        f"forced triple and proposer; schema {results[0]['schema_version']},"
        f" commit {results[0]['git_commit']}")
    return dict(passes=len(results), rows=rows)


def roofline_phase(torch, cfg_mod, build_model, counted, dev, card):
    """Phase 45: the dry run over every arch x shape with probes (in its own
    process), then one llama31-8b prefill step at 8 x 512 in bf16 on the
    card, whose counted FLOPs must equal its meta count."""
    import subprocess
    import tempfile

    from repro_torch.bench.common import time_ms
    from repro_torch.config import ShapeCell
    from repro_torch.configs import ASSIGNED_LM_ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.models.api import input_specs
    from repro_torch.roofline.analysis import RooflineReport, step_costs
    from repro_torch.roofline.model_flops import model_flops

    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--probes", "--out", tmp],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        if r.returncode != 0:
            raise AssertionError(f"45: dryrun exited {r.returncode}: "
                                 f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
        recs = {(a, s): json.loads((Path(tmp) / f"{a}__{s}__1.json")
                                   .read_text())
                for a in ASSIGNED_LM_ARCHS for s in cfg_mod.SHAPES}
    out["dryrun_s"] = round(time.perf_counter() - t0, 1)
    cells = {}
    for (arch, shape), rec in recs.items():
        if (arch, shape) in dryrun.SKIP:
            if rec["status"] != "skipped" or \
                    rec["reason"] != dryrun.SKIP[arch, shape]:
                raise AssertionError(f"45 {arch} x {shape}: {rec}")
            continue
        if rec["status"] != "ok" or rec["probe_flops_rel_err"] > 1e-9:
            raise AssertionError(f"45 {arch} x {shape}: {rec}")
        rl = rec["roofline"]
        cfg = cfg_mod.get_config(arch)
        if (shape == "train_4k" and cfg.family == "dense"
                and not 0.5 < rl["useful_flops_ratio"] <= 1.2):
            raise AssertionError(f"45 {arch} train_4k: useful FLOPs ratio "
                                 f"{rl['useful_flops_ratio']:.3f}")
        cells[f"{arch} x {shape}"] = {
            "flops": rl["hlo_flops"], "bytes": rl["hlo_bytes"],
            "peak_gib": round(rl["memory_per_device"] / 2 ** 30, 2),
            "bottleneck": rl["bottleneck"],
            "step_ms": round(max(rl["t_compute"], rl["t_memory"]) * 1e3, 4),
            "useful": round(rl["useful_flops_ratio"], 4),
            "count_s": round(rec["count_s"], 2),
            "probe_bytes_rel_err": rec["probe_bytes_rel_err"]}
        log(f"    {arch} x {shape}: {cells[f'{arch} x {shape}']}")
    out["cells"] = cells
    log(f"  45 dry run: {len(cells)} cells ok, "
        f"{len(recs) - len(cells)} skipped, probes exact, "
        f"{out['dryrun_s']} s")

    # one real step on the card against its meta count
    cfg = cfg_mod.get_config("llama31-8b")
    cell = ShapeCell("prefill_8x512", 512, 8, "prefill")
    meta = dryrun.count_cell(cfg, cell)
    gc.collect()
    torch.cuda.empty_cache()
    model = dryrun.cell_model(cfg, cell, device=dev)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (8, 512), dtype=torch.int32,
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(45))
    inputs = dict(input_specs(cfg, cell), tokens=tokens)
    fn, args = dryrun.cell_step(model, cell, params, inputs)
    reset_counts(counted)
    real = step_costs(fn, *args)
    ms = time_ms(fn, *args, device=dev)
    if any(op.launches for op in counted):
        raise AssertionError("45: the prefill step launched a kernel of "
                             "the port (the reference's is plain)")
    if real["flops"] != meta["flops"]:
        raise AssertionError(f"45: card FLOPs {real['flops']} != meta "
                             f"{meta['flops']}")
    rep = RooflineReport(arch="llama31-8b", shape=cell.name, mesh="1",
                         chips=1, hlo_flops=real["flops"],
                         hlo_bytes=real["bytes"], collective_bytes=0.0,
                         model_flops=model_flops(cfg, cell),
                         memory_per_device=real["peak_memory"],
                         dtype=torch.bfloat16)
    mfu = rep.model_flops / (rep.hw.peak_bf16 * ms * 1e-3)
    out["llama31_8b_prefill_8x512"] = dict(
        flops=real["flops"], meta_flops=meta["flops"], bytes=real["bytes"],
        meta_bytes=meta["bytes"], peak_memory=real["peak_memory"],
        meta_peak_memory=meta["peak_memory"],
        max_memory_allocated=real["max_memory_allocated"], ms=ms,
        roofline_step_ms=rep.step_time * 1e3, bottleneck=rep.bottleneck,
        model_flops=rep.model_flops, mfu=mfu, roofline_mfu=rep.mfu,
        useful_flops_ratio=rep.useful_flops_ratio)
    log(f"  45 llama31-8b prefill 8 x 512 bf16 on the card: FLOPs "
        f"{real['flops']:.6g} = meta {meta['flops']:.6g}; bytes "
        f"{real['bytes']:.6g} (meta {meta['bytes']:.6g}); measured "
        f"{ms:.3f} ms against the roofline's {rep.step_time * 1e3:.3f} ms "
        f"({rep.bottleneck}); MFU {mfu:.4f} (roofline {rep.mfu:.4f}); "
        f"counted peak {real['peak_memory'] / 2 ** 30:.2f} GiB, allocator "
        f"peak {real['max_memory_allocated'] / 2 ** 30:.2f} GiB ({card})")
    del model, params, fn, args
    return out


def energy_phase(torch, emb_api, counted, dev, card):
    """Phase 46: energy per inference of rm1 and rm2 at 1 M rows a table
    and B 4096, BatchedTable and SingleTable, from the card's energy
    counter over loops of at least 2 s; the idle watts first."""
    from repro_torch.bench import energy, recsys_e2e

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    time.sleep(1.0)
    counter = energy.EnergyCounter(dev)
    idle = counter.watts()
    log(f"  idle before the first loop: {idle:.1f} W (NVML, bus "
        f"{counter.bus_id}; {card})")
    reset_counts(counted)
    rows = recsys_e2e.run(dev, batches=(EMB_BATCH,))
    torch.cuda.synchronize()
    launches = emb_api.embedding_bag.launches
    forwards = sum(r["calls"] for r in rows if r["use_batched"])
    if launches != forwards or launches == 0:
        raise AssertionError(f"46: B4 launches {launches} != BatchedTable "
                             f"forwards {forwards}")
    out = {"idle_watts": idle, "b4_launches": launches}
    for r in rows:
        if "energy_uJ_per_inf" not in r or not r["finite"]:
            raise AssertionError(f"46 {r['name']}: no energy reading")
        out[r["name"]] = dict(uJ_per_inf=r["energy_uJ_per_inf"],
                              watts=r["watts"], ms=r["ms"],
                              loop_s=r["energy_s"])
        log(f"    {r['name']}: {r['energy_uJ_per_inf']:.3f} uJ per "
            f"inference, {r['watts']:.1f} W over {r['energy_s']:.2f} s, "
            f"{r['ms']:.4f} ms a forward ({card})")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
