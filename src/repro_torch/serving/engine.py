"""Scheduler-driven serving engine over the paged KV cache (port of the
draftless synchronous path of ``repro.serving.engine``).

Each :meth:`ServingEngine.step` schedules on the host
(:mod:`repro_torch.serving.scheduler`), renders the plan into flat token
lanes plus BlockList and ragged metadata (:meth:`_render`, the reference's
power-of-two lane and slot buckets, so the host arrays match the
reference's exactly), runs ONE fused forward (``decode_tokens_paged``: per
layer a hand-written paged-attention kernel on a card) and
``sample_batched`` (:meth:`_build`), then commits the sampled tokens
(:meth:`_resolve`).  ``_build`` and ``_resolve`` run back to back, as the
reference does with ``overlap=False``.

``ServeConfig.attn_impl`` picks the attention kernel of every layer:
``"ragged"`` (the default) or ``"chunked"`` (tuned by ``q_chunk`` and
``prefetch_depth``); greedy streams are identical either way.

Not in the port yet, refused at construction with ``NotImplementedError``:
the overlapped loop (``overlap=True``), speculative decoding
(``spec != "off"``), a mesh or ``devices > 1``, the host KV tier
(``host_blocks > 0``) and the prefill role of disaggregated serving.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.core.paged_kv import (
    BlockAllocator, copy_pool_blocks, make_fused_pool)
from repro_torch.serving import policy as policy_lib
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import (
    Request, RequestState, SamplingParams, bucket_pow2)
from repro_torch.serving.scheduler import Scheduler, StepPlan

__all__ = ["Request", "RequestState", "SamplingParams", "ServingEngine"]


class _PendingStep:
    """One dispatched, not yet committed step: its actions ``(kind, req,
    n, pos0, out_idx)``, the slots at build time and the sampled tokens
    (still on the device)."""

    __slots__ = ("actions", "slots", "nxt_dev", "phases", "num_tokens",
                 "t_dispatch")

    def __init__(self, *, actions, slots, nxt_dev, phases, num_tokens,
                 t_dispatch):
        self.actions = actions
        self.slots = slots
        self.nxt_dev = nxt_dev
        self.phases = phases
        self.num_tokens = num_tokens
        self.t_dispatch = t_dispatch


def _refuse(serve: ServeConfig, mesh, role: str) -> None:
    unsupported = {
        "overlap=True": serve.overlap,
        f"spec={serve.spec!r}": serve.spec != "off",
        "a mesh": mesh is not None,
        f"devices={serve.devices}": serve.devices > 1,
        f"host_blocks={serve.host_blocks}": serve.host_blocks > 0,
        f"roles={serve.roles!r}": bool(serve.roles),
        f"role={role!r}": role == "prefill",
    }
    for what, hit in unsupported.items():
        if hit:
            raise NotImplementedError(
                f"{what}: the port serves the draftless synchronous "
                "single-device path only")
    if role != "full":
        raise ValueError(f"unknown engine role {role!r}")
    if serve.attn_impl not in ("ragged", "chunked"):
        raise ValueError(f"attn_impl {serve.attn_impl!r}: expected 'ragged' "
                         "or 'chunked'")


class ServingEngine:
    def __init__(self, model, params, cfg: ModelConfig, serve: ServeConfig,
                 *, num_blocks: Optional[int] = None, eos_id: int = -1,
                 token_budget: Optional[int] = None, seed: int = 0,
                 admission=None, preemption=None, eviction=None,
                 mesh=None, role: str = "full", device="cuda"):
        _refuse(serve, mesh, role)
        self.device = device_lib.resolve(device)
        self.model = model
        self.cfg = cfg
        self.serve = serve
        self.eos_id = eos_id
        self.role = role
        bs = serve.kv_block_size
        nb = num_blocks or serve.max_blocks or serve.max_batch * 64
        a = cfg.attention
        adm, pre, evi = policy_lib.resolve_triple(
            admission=admission, preemption=preemption, eviction=eviction,
            config=serve)
        self.policies = {p.axis: p.name for p in (adm, pre, evi)}
        self._policy_objs = (adm, pre, evi)
        self.alloc = BlockAllocator(num_blocks=nb, block_size=bs,
                                    eviction_policy=evi)
        self.pools = {"kv": make_fused_pool(
            cfg.num_layers, nb, bs, a.num_kv_heads, a.head_dim,
            model.dtype, self.device)}
        self.params = params
        self.B = serve.max_batch
        self.max_total = nb
        self.scheduler = Scheduler(
            self.alloc, max_batch=self.B,
            token_budget=token_budget or serve.prefill_chunk,
            admission=adm, preemption=pre)
        self.finished: List[Request] = []
        self.attn_impl = serve.attn_impl
        self.q_chunk = int(serve.q_chunk)
        self.prefetch_depth = int(serve.prefetch_depth)
        # "cuda": the hand-written kernel; "plain": its PyTorch version
        kernel = "cuda" if self.device.type == "cuda" else "plain"
        self._metrics = EngineMetrics(backend=kernel)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    # -------------------------------------------------------------- lifecycle
    def submit(self, req: Request) -> None:
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.req_id}: empty prompt")
        bs = self.alloc.block_size
        positions = len(req.prompt) + max(req.max_new_tokens - 1, 0)
        worst = max(-(-positions // bs), -(-len(req.prompt) // bs) + 1)
        if worst > self.alloc.num_blocks:
            raise ValueError(
                f"request {req.req_id} can never fit: needs up to {worst} "
                f"blocks, pool has {self.alloc.num_blocks}")
        self.scheduler.submit(req)

    @property
    def waiting(self) -> List[Request]:
        return list(self.scheduler.waiting)

    @property
    def active(self) -> Dict[int, Request]:
        return self.scheduler.running

    # ------------------------------------------------------------- step build
    def _render(self, plan: StepPlan):
        """Render a StepPlan into host (numpy) arrays: ``(lists, tokens,
        (temps, top_ks, top_ps), committed)``.  Reserves this step's KV
        slots in the allocator (copy-on-write included)."""
        alloc, B = self.alloc, self.B
        T = bucket_pow2(plan.num_tokens)
        reqs = list(plan.decode) + [req for req, _ in plan.prefill]
        Bs = min(bucket_pow2(1 + max(req.slot for req in reqs)), B)
        tokens = np.zeros((T,), np.int32)
        token_req = np.full((T,), Bs, np.int32)         # Bs == padding lane
        token_pos = np.zeros((T,), np.int32)
        slots = np.full((T, 2), (self.max_total, 0), np.int32)  # dropped
        last_lane = np.zeros((Bs,), np.int32)
        kv_lens = np.zeros((Bs,), np.int32)
        temps = np.zeros((Bs,), np.float32)
        top_ks = np.zeros((Bs,), np.int32)
        top_ps = np.ones((Bs,), np.float32)
        lane = 0
        committed: List[tuple] = []             # (req, n_tokens, start_pos)
        for req in plan.decode:
            pos = alloc.seq_len(req.req_id)
            slots[lane] = alloc.reserve_tokens(req.req_id, 1)[0]
            tokens[lane] = req.output[-1]
            token_req[lane] = req.slot
            token_pos[lane] = pos
            last_lane[req.slot] = lane
            kv_lens[req.slot] = pos + 1
            lane += 1
            committed.append((req, 1, pos))
        for req, n in plan.prefill:
            pos0 = alloc.seq_len(req.req_id)
            ss = alloc.reserve_tokens(req.req_id, n)
            tokens[lane:lane + n] = req.active_prompt[pos0:pos0 + n]
            token_req[lane:lane + n] = req.slot
            token_pos[lane:lane + n] = pos0 + np.arange(n)
            slots[lane:lane + n] = ss
            last_lane[req.slot] = lane + n - 1
            kv_lens[req.slot] = pos0 + n
            lane += n
            committed.append((req, n, pos0))
        for req, _, _ in committed:
            temps[req.slot] = req.sampling.temperature
            top_ks[req.slot] = req.sampling.top_k
            top_ps[req.slot] = req.sampling.top_p
        # Block lists AFTER reservations (tables may have grown / CoW'd);
        # shared prefix blocks count once per holder, so the capacity grows
        # past the pool size by power-of-two buckets.
        tables = {req.req_id: alloc.table(req.req_id)
                  for req, _, _ in committed}
        needed = sum(len(t) for t in tables.values())
        cap = (self.max_total if needed <= self.max_total
               else bucket_pow2(needed, lo=self.max_total))
        bl = np.zeros((cap,), np.int32)
        br = np.full((cap,), Bs, np.int32)
        bp = np.zeros((cap,), np.int32)
        cursor = 0
        for req, _, _ in committed:
            table = tables[req.req_id]
            n = len(table)
            bl[cursor:cursor + n] = table
            br[cursor:cursor + n] = req.slot
            bp[cursor:cursor + n] = np.arange(n)
            cursor += n
        # Ragged metadata: one contiguous lane run per committed entry, in
        # the order the lanes were rendered.
        q_lens = np.zeros((Bs,), np.int64)
        kv_l = np.zeros((Bs,), np.int64)
        seq_slot = np.full((Bs,), Bs, np.int32)         # Bs == dropped slot
        for j, (req, n, pos0) in enumerate(committed):
            seq_slot[j] = req.slot
            q_lens[j] = n
            kv_l[j] = pos0 + n
        cu_q = np.zeros((Bs + 1,), np.int32)
        cu_kv = np.zeros((Bs + 1,), np.int32)
        cu_q[1:] = np.cumsum(q_lens)
        cu_kv[1:] = np.cumsum(kv_l)
        lists = {
            "block_list": bl, "block_req": br, "block_pos": bp,
            "kv_lens": kv_lens, "token_req": token_req,
            "token_pos": token_pos, "cu_q_lens": cu_q, "cu_kv_lens": cu_kv,
            "seq_slot": seq_slot, "slots": slots, "last_lane": last_lane,
        }
        return lists, tokens, (temps, top_ks, top_ps), committed

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # -------------------------------------------------------------- main loop
    def step(self) -> int:
        """One engine iteration: schedule + ONE fused prefill/decode
        forward with sampling + host-side commit. Returns #tokens run."""
        t0 = time.perf_counter()
        plan = self.scheduler.schedule()
        if plan.num_tokens == 0:
            self._metrics.record_step(
                num_tokens=0, emitted_tokens=0, idle=True,
                phases={"idle": time.perf_counter() - t0})
            return 0
        self._resolve(self._build(plan, t0))
        return plan.num_tokens

    def _drain_cow(self) -> None:
        """Apply pending copy-on-write block copies to the device pool."""
        copies = self.alloc.drain_copies()
        if copies:
            srcs = np.asarray([s for s, _ in copies], np.int64)
            dsts = np.asarray([d for _, d in copies], np.int64)
            for p in self.pools.values():
                copy_pool_blocks(p, srcs, dsts)

    def sync_pools(self) -> None:
        """Flush allocator-queued device-pool traffic (CoW copies)."""
        self._drain_cow()

    def _build(self, plan: StepPlan, t1: float) -> _PendingStep:
        """Render + run the fused step and commit it provisionally: KV
        slots are committed, decode-ish actions append a placeholder token
        (the sampled value is still on the device), prefill chunks advance
        and publish their prefix blocks."""
        lists_np, tokens_np, sample_np, committed = self._render(plan)
        self.sync_pools()
        lists = {k: self._upload(v) for k, v in lists_np.items()}
        temps, top_ks, top_ps = (self._upload(v) for v in sample_np)
        t2 = time.perf_counter()
        logits, self.pools = self.model.decode_tokens_paged(
            self.params, self.pools, lists, self._upload(tokens_np),
            num_lanes=plan.num_tokens, attn_impl=self.attn_impl,
            q_chunk=self.q_chunk, prefetch_depth=self.prefetch_depth)
        nxt_dev = sampling_lib.sample_batched(self._gen, logits, temps,
                                              top_ks, top_ps)
        actions = []
        for req, n, pos0 in committed:
            rid = req.req_id
            self.alloc.commit_tokens(rid, n)
            if req.state is RequestState.DECODING:
                req.output.append(0)            # placeholder: value in flight
                actions.append(("decode", req, n, pos0, len(req.output) - 1))
            else:                               # prefill chunk
                start = req.prefill_pos
                req.prefill_pos += n
                self.alloc.register_prefix(rid, req.active_prompt,
                                           req.prefill_pos, start=start)
                out_idx = None
                if req.prefill_remaining == 0:  # final chunk samples a token
                    req.to_state(RequestState.DECODING)
                    req.output.append(0)
                    out_idx = len(req.output) - 1
                actions.append(("prefill", req, n, pos0, out_idx))
        return _PendingStep(
            actions=actions,
            slots={req.req_id: req.slot for req, _, _ in committed},
            nxt_dev=nxt_dev, phases={"schedule_render": t2 - t1},
            num_tokens=plan.num_tokens, t_dispatch=t2)

    def _resolve(self, pend: _PendingStep) -> None:
        """Wait for the step's sampled tokens and commit them: placeholders
        become tokens, EOS / max_new_tokens finishes fire, and the step's
        metrics are recorded (the device phase spans dispatch -> tokens)."""
        nxt = pend.nxt_dev.cpu().numpy()        # waits for the step
        t_done = time.perf_counter()
        now = time.time()
        emitted = 0
        for kind, req, n, pos0, out_idx in pend.actions:
            if out_idx is None:
                continue                        # chunk-only prefill
            tok = int(nxt[pend.slots[req.req_id]])
            req.output[out_idx] = tok
            emitted += 1
            if kind == "decode":
                self._register_generated(req, pos0, new_len=pos0 + n)
            elif req.first_token_at is None:
                req.first_token_at = now
            if out_idx + 1 >= req.max_new_tokens or tok == self.eos_id:
                self._finish(req, now)
        self._metrics.record_step(
            num_tokens=pend.num_tokens, emitted_tokens=emitted,
            phases={**pend.phases, "device": t_done - pend.t_dispatch,
                    "commit": time.perf_counter() - t_done})

    def _register_generated(self, req: Request, pos0: int,
                            new_len: int) -> None:
        """Hash-register full KV blocks filled by this step's decode token,
        so preemption-resume recompute and repeated prompt+generation
        prefixes hit the prefix cache."""
        bs = self.alloc.block_size
        if pos0 // bs == new_len // bs:         # no block filled this step
            return
        self.alloc.register_prefix(req.req_id, req.resume_tokens(), new_len,
                                   start=pos0)

    def _finish(self, req: Request, now: float) -> None:
        self.scheduler.release(req)
        req.finish(now)
        self.finished.append(req)
        self._metrics.record_finished(
            ttft=req.ttft, tpot=req.tpot, num_output_tokens=len(req.output),
            arrival=req.arrival, done_at=now)

    @property
    def busy(self) -> bool:
        return self.scheduler.has_work()

    def run_until_done(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.busy:
                return
            self.step()
        raise RuntimeError("serving did not converge")

    # --------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, object]:
        m = self._metrics.summary()
        hits, misses = self.alloc.prefix_hits, self.alloc.prefix_misses
        m.update({
            "devices": 1,
            "overlap": False,
            "prefetch_depth": self.prefetch_depth,
            "q_chunk": self.q_chunk,
            "attn_impl": self.attn_impl,
            "blocks_free": self.alloc.num_free,
            "preemptions": self.scheduler.num_preemptions,
            "slot_compactions": self.scheduler.num_slot_compactions,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "cow_copies": self.alloc.cow_copies,
            "role": self.role,
        })
        for axis, name in self.policies.items():
            m[f"{axis}_policy"] = name
        m["policy_counters"] = {
            f"{p.axis}.{k}": v
            for p in self._policy_objs for k, v in sorted(p.counters.items())}
        return m
