"""Serving scheduler: admission, chunked-prefill budgeting, preemption
(port of ``repro.serving.scheduler``, draftless).

Per engine step the scheduler compacts slots, admits waiting requests in
the admission policy's order while a slot is free and the allocator can
hold the prompt, fast-forwards mid-prefill requests over blocks published
since their admission, gives every DECODING request its lane and shares
the token budget among prefill chunks, and preempts the preemption
policy's top victim until the plan's block demand fits the pool.  It owns
the queues and the slot free-list and never touches device state.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.paged_kv import BlockAllocator, OutOfBlocksError
from repro_torch.serving import policy as policy_lib
from repro_torch.serving.request import Request, RequestState


@dataclass
class StepPlan:
    """What the engine runs this step: one lane per decode request plus
    ``n`` lanes per ``(req, n)`` prefill chunk."""

    decode: List[Request] = field(default_factory=list)
    prefill: List[Tuple[Request, int]] = field(default_factory=list)

    @property
    def num_tokens(self) -> int:
        return len(self.decode) + sum(n for _, n in self.prefill)


class Scheduler:
    def __init__(self, alloc: BlockAllocator, *, max_batch: int,
                 token_budget: int,
                 admission: Optional[policy_lib.AdmissionPolicy] = None,
                 preemption: Optional[policy_lib.PreemptionPolicy] = None):
        self.alloc = alloc
        self.max_batch = max_batch
        self.token_budget = max(1, token_budget)
        self.admission = admission or policy_lib.resolve(policy_lib.ADMISSION)
        self.preemption = (preemption
                           or policy_lib.resolve(policy_lib.PREEMPTION))
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.free_slots: List[int] = list(range(max_batch - 1, -1, -1))
        self.num_preemptions = 0
        self.num_slot_compactions = 0

    def submit(self, req: Request) -> None:
        if req.state is not RequestState.WAITING:
            raise ValueError(f"request {req.req_id} is {req.state.name}")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def _compact_slots(self) -> None:
        """Remap running requests into freed lower slots (highest first)."""
        if not self.free_slots:
            return
        self.free_slots.sort(reverse=True)          # lowest slot at pop() end
        for req in sorted(self.running.values(),
                          key=lambda r: r.slot, reverse=True):
            low = self.free_slots[-1]
            if low >= req.slot:
                break
            self.free_slots[-1] = req.slot
            req.slot = low
            self.free_slots.sort(reverse=True)
            self.num_slot_compactions += 1

    def _admit(self) -> None:
        now = time.time()
        while self.waiting and self.free_slots:
            req = self.admission.select(self.waiting, now)
            active = req.resume_tokens()
            bs = self.alloc.block_size
            cached = self.alloc.peek_prefix(active)
            total_blocks = max(1, -(-len(active) // bs))
            fresh = max(total_blocks - cached // bs, 0) + 1  # +1 decode slack
            if self.alloc.num_free < fresh:
                if (not self.running
                        and self.alloc.num_free == self.alloc.num_blocks):
                    raise OutOfBlocksError(
                        f"request {req.req_id} needs {fresh} blocks but the "
                        f"whole pool is only {self.alloc.num_blocks}")
                break                     # policy head-of-line: no jumping
            self.waiting.remove(req)
            slot = self.free_slots.pop()
            cached = self.alloc.allocate_prefix(req.req_id, active)
            req.begin_prefill(slot, cached, active_prompt=active)
            self.running[req.req_id] = req
            self.admission.on_admit(req, now)

    def _blocks_needed(self, plan: StepPlan) -> int:
        """Exact pool demand of the plan: new blocks + copy-on-write copies."""
        bs = self.alloc.block_size
        need = 0
        cow_writers: Dict[int, int] = {}

        def span(req: Request, n: int) -> int:
            pos = self.alloc.seq_len(req.req_id)
            table = self.alloc.table(req.req_id)
            last_bi = (pos + n - 1) // bs
            fresh = max(last_bi + 1 - len(table), 0)
            for bi in range(pos // bs, min(last_bi, len(table) - 1) + 1):
                if self.alloc.ref_count(table[bi]) > 1:
                    cow_writers[table[bi]] = cow_writers.get(table[bi], 0) + 1
            return fresh

        for req in plan.decode:
            need += span(req, 1)
        for req, n in plan.prefill:
            need += span(req, n)
        for blk, writers in cow_writers.items():
            need += min(writers, self.alloc.ref_count(blk) - 1)
        return need

    def _pick_victim(self, now: float) -> Optional[Request]:
        ranked = self.preemption.rank(list(self.running.values()),
                                      self.alloc, now)
        if len(ranked) < 2:
            return None
        return ranked[0]

    def release(self, req: Request) -> None:
        """Return a running request's blocks and slot (finish or preempt)."""
        self.alloc.free(req.req_id)
        del self.running[req.req_id]
        self.free_slots.append(req.slot)

    def _preempt(self, req: Request) -> None:
        self.preemption.on_preempt(req, self.alloc)
        self.release(req)
        req.preempt()
        self.waiting.appendleft(req)
        self.num_preemptions += 1

    def schedule(self) -> StepPlan:
        """Compact, admit, budget prefill chunks, preempt until it fits."""
        self._compact_slots()
        self._admit()
        for req in self.running.values():
            if req.state is RequestState.PREFILLING:
                adopted = self.alloc.extend_prefix(req.req_id,
                                                   req.active_prompt)
                if adopted:
                    req.prefill_pos += adopted
        while True:
            plan = StepPlan()
            budget = self.token_budget
            for req in self.running.values():
                if (req.state is RequestState.DECODING
                        and len(req.output) < req.max_new_tokens):
                    plan.decode.append(req)
            for req in self.running.values():
                if req.state is RequestState.PREFILLING and budget > 0:
                    n = min(req.prefill_remaining, budget)
                    if n > 0:
                        plan.prefill.append((req, n))
                        budget -= n
            if self._blocks_needed(plan) <= self.alloc.num_free:
                return plan
            victim = self._pick_victim(now=time.time())
            if victim is None:
                raise OutOfBlocksError(
                    "a single request exceeds the KV pool; cannot preempt "
                    "further")
            self._preempt(victim)
