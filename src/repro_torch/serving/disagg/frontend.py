"""Role-aware frontend for disaggregated prefill/decode serving (port of
``repro.serving.disagg.frontend``).

Prefill is compute-bound and decode bandwidth- and latency-bound (the
paper's §4.2 asymmetry): with the two on separate engines, a burst of long
prompts loads the *prefill* engine while the *decode* engine keeps its own
cadence instead of carrying prompt chunks in every step.
:class:`DisaggEngine` wires two ordinary
:class:`~repro_torch.serving.engine.ServingEngine` instances that way:

* the prefill engine (``role="prefill"``) admits and chunk-prefills
  prompts like the monolithic engine, but parks a request whose last
  chunk commits instead of decoding it;
* the frontend takes the parked requests (``take_prefilled``), hands each
  off, and submits a clone to the decode engine, which runs the unchanged
  full engine (speculation, overlap, policies and the host tier apply).

Handoff contract (public allocator API only):

1. every committed token of the parked request is KV-written
   (``BlockAllocator.transferable``: the per-block watermarks prove it);
2. the prompt's FULL blocks are staged in the decode pool under a reserved
   negative request id: ``allocate_prefix`` adopts what the decode cache
   already holds (HBM hits and host-tier promotions count),
   ``reserve_tokens``/``commit_tokens`` take the rest, whose KV
   :func:`copy_block_tokens` copies, and ``register_prefix`` publishes
   their hashes;
3. the prefill engine frees its copy: the blocks park cached-free, so its
   prefix cache stays warm for repeated prompts;
4. the clone is submitted to the decode engine as a new WAITING request.
   Admission adopts every staged block and recomputes the sub-block tail
   and the last prompt token (the prefix cache's last-token rule).  The
   staging id is released once the clone has left WAITING, so nothing can
   evict the staged blocks while it queues.

A prompt shorter than one block has no KV to transfer and goes straight to
the decode engine.

The loop is serial (one prefill step, the handoffs it unlocked, then up to
``decode_steps_per_step`` decode steps), so runs are reproducible; greedy
tokens depend on KV content only, so outputs do not depend on the
interleave ratio.  On the CPU, and in float32 on a card, the streams
equal the monolithic engine's.  On a card in bf16 the decode engine
computes the last prompt token as a one-lane attention owner, where the
monolithic engine computed it inside a prefill chunk, so a stream may
part from the monolithic one where its top two logits lie within a few
bf16 ulps.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.analysis import sanitize as sanitize_lib
from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.metrics import LatencyTracker
from repro_torch.serving.request import RequestState

__all__ = ["DisaggEngine", "copy_block_tokens", "parse_roles"]


def parse_roles(roles: str) -> Tuple[str, ...]:
    """Validate a ``ServeConfig.roles`` string -> role tuple ("" = mono)."""
    if not roles:
        return ()
    parts = tuple(p.strip() for p in roles.replace("+", ",").split(",")
                  if p.strip())
    if parts in (("split",), ("prefill", "decode"), ("decode", "prefill")):
        return ("prefill", "decode")
    raise ValueError(
        f"unsupported roles spec {roles!r}; use 'prefill,decode' (or 'split')")


def copy_block_tokens(dst_pools, src_pools, src_slots: np.ndarray,
                      dst_slots: np.ndarray):
    """Copy per-token KV entries between two layer-stacked pools, in place.

    ``src_slots`` / ``dst_slots`` are (n, 2) ``[block, offset]`` arrays (as
    ``reserve_tokens`` returns them).  Pools on one device copy device to
    device, in stream order after the steps that wrote the source; pools
    on different devices go through host memory (``sanitize.host_read``,
    declared as ``disagg-handoff``).
    Returns ``dst_pools``.
    """
    for c, dst in dst_pools.items():     # ONE fused kv channel
        src = src_pools[c]
        sb, so = (torch.as_tensor(np.asarray(src_slots[:, i]),
                                  dtype=torch.long).to(src.device)
                  for i in (0, 1))
        db, do = (torch.as_tensor(np.asarray(dst_slots[:, i]),
                                  dtype=torch.long).to(dst.device)
                  for i in (0, 1))
        vals = src[:, sb, so]                               # (L, n, ...)
        if vals.device != dst.device:
            vals = sanitize_lib.host_read(vals, reason="disagg-handoff")
        dst[:, db, do] = vals.to(dst.device, dst.dtype)
    return dst_pools


def _on_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _on_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class DisaggEngine:
    """Two-role disaggregated serving frontend (see the module docstring).

    Mirrors the :class:`ServingEngine` surface the launcher and the bench
    use: ``submit`` / ``step`` / ``run_until_done`` / ``finished`` /
    ``metrics``.  ``devices`` places the (prefill, decode) engines; both
    default to ``device``.
    """

    def __init__(self, model, params, cfg: ModelConfig, serve: ServeConfig,
                 *, num_blocks: Optional[int] = None,
                 prefill_blocks: Optional[int] = None,
                 decode_blocks: Optional[int] = None,
                 eos_id: int = -1, token_budget: Optional[int] = None,
                 seed: int = 0, devices: Optional[Sequence] = None,
                 decode_steps_per_step: int = 4, device="cuda"):
        if parse_roles(serve.roles or "prefill,decode") != ("prefill",
                                                           "decode"):
            raise ValueError(f"unsupported roles {serve.roles!r}")
        if serve.devices > 1:
            raise ValueError(
                "disaggregated roles run one engine per role; pass per-role "
                "devices via the `devices` pair, not ServeConfig.devices")
        if devices is not None and len(devices) != 2:
            raise ValueError("devices must be a (prefill, decode) pair")
        devs = tuple(devices) if devices is not None else (device, device)
        # the prefill role never decodes: speculation is off there; the
        # chunk budget, overlap, policies and host tier apply to both
        pre_serve = dataclasses.replace(serve, roles="", spec="off")
        dec_serve = dataclasses.replace(serve, roles="")

        def build(role: str, sv: ServeConfig, nb: Optional[int], dev):
            dev = device_lib.resolve(dev)
            p = params
            if model.device != dev:
                p = _on_device(params, dev)
            return ServingEngine(model, p, cfg, sv, num_blocks=nb,
                                 eos_id=eos_id, token_budget=token_budget,
                                 seed=seed, role=role, device=dev)

        self.pre = build("prefill", pre_serve,
                         prefill_blocks or num_blocks, devs[0])
        self.dec = build("full", dec_serve,
                         decode_blocks or num_blocks, devs[1])
        self.block_size = serve.kv_block_size
        self.eos_id = eos_id
        self.decode_steps_per_step = max(1, decode_steps_per_step)
        self.finished: List[Request] = self.dec.finished   # shared list
        self.handoff = LatencyTracker()                    # seconds parked
        self.num_handoffs = 0
        self.num_direct = 0        # sub-block prompts routed straight to dec
        self._pending_handoffs: Deque[Tuple[Request, float]] = deque()
        self._originals: Dict[int, Request] = {}
        self._dreqs: Dict[int, Request] = {}
        self._staged: Dict[int, int] = {}                  # rid -> staging id

    # -------------------------------------------------------------- lifecycle
    @staticmethod
    def _clone(req: Request, max_new: int) -> Request:
        """A fresh WAITING copy for one role (identity and policy fields)."""
        return Request(req_id=req.req_id, prompt=req.prompt,
                       max_new_tokens=max_new, sampling=req.sampling,
                       arrival=req.arrival, priority=req.priority,
                       deadline=req.deadline)

    def submit(self, req: Request) -> None:
        if req.req_id < 0:
            raise ValueError(
                f"request {req.req_id}: negative ids are reserved for "
                "handoff staging")
        if req.req_id in self._originals:
            raise ValueError(f"request {req.req_id}: duplicate id")
        full = len(req.prompt) // self.block_size
        if full > 0 and full + 2 > self.dec.alloc.num_blocks:
            raise ValueError(
                f"request {req.req_id}: handoff stages {full} full blocks "
                f"and admission needs 2 more, decode pool has only "
                f"{self.dec.alloc.num_blocks}")
        self._originals[req.req_id] = req
        if full == 0:
            # no transferable KV in a sub-block prompt: the decode engine
            # prefills it itself
            dreq = self._clone(req, req.max_new_tokens)
            self._dreqs[req.req_id] = dreq
            self.dec.submit(dreq)
            self.num_direct += 1
            return
        self.pre.submit(self._clone(req, 1))     # max_new sizes decode slack

    def step(self) -> int:
        """One frontend iteration: a prefill step, the handoffs it
        unlocked, then up to ``decode_steps_per_step`` decode steps.
        Returns the lanes run on both engines."""
        n = 0
        if self.pre.busy:
            n += self.pre.step()
            t = time.perf_counter()
            for req in self.pre.take_prefilled():
                self._pending_handoffs.append((req, t))
        self._try_handoffs()
        for _ in range(self.decode_steps_per_step):
            if not self.dec.busy:
                break
            n += self.dec.step()
            self._release_staged()
            self._try_handoffs()
        return n

    @property
    def busy(self) -> bool:
        return (self.pre.busy or self.dec.busy
                or bool(self._pending_handoffs))

    def run_until_done(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.busy:
                return
            self.step()
        raise RuntimeError("disaggregated serving did not converge")

    # ---------------------------------------------------------------- handoff
    def _try_handoffs(self) -> None:
        """Move parked prefills into the decode pool, FIFO, while they fit:
        every full block fresh plus one copy-on-write for a fully cached
        tail.  A request that does not fit stays parked, its prefill-side
        blocks intact, until the decode pool can take it."""
        while self._pending_handoffs:
            req, t0 = self._pending_handoffs[0]
            full = len(req.prompt) // self.block_size
            if self.dec.alloc.num_free < full + 1:
                break
            self._pending_handoffs.popleft()
            self._handoff(req)
            self.handoff.record(time.perf_counter() - t0)
            self.num_handoffs += 1

    def _handoff(self, preq: Request) -> None:
        rid = preq.req_id
        prompt = np.asarray(preq.prompt, np.int32)
        bs = self.block_size
        n_import = (len(prompt) // bs) * bs
        pre_alloc, dec_alloc = self.pre.alloc, self.dec.alloc
        assert pre_alloc.seq_len(rid) >= n_import, (
            rid, pre_alloc.seq_len(rid), n_import)
        assert pre_alloc.transferable(rid), (
            f"request {rid}: parked blocks not fully KV-written")
        pre_table = pre_alloc.table(rid)
        hand = -rid - 1                         # staging id (disjoint space)
        cached = dec_alloc.allocate_prefix(hand, prompt)
        if cached < n_import:
            dst = dec_alloc.reserve_tokens(hand, n_import - cached)
            src = np.array([(pre_table[p // bs], p % bs)
                            for p in range(cached, n_import)], np.int32)
            # flush queued CoW / tier traffic first: a whole-block copy or
            # promote applied after these slot writes would clobber them
            self.dec.sync_pools()
            copy_block_tokens(self.dec.pools, self.pre.pools, src, dst)
            dec_alloc.commit_tokens(hand, n_import - cached)
        dec_alloc.register_prefix(hand, prompt, n_import, start=0)
        pre_alloc.free(rid)         # the prefill copy parks cached-free
        dreq = self._clone(self._originals[rid],
                           self._originals[rid].max_new_tokens)
        self._dreqs[rid] = dreq
        self._staged[rid] = hand
        self.dec.submit(dreq)

    def _release_staged(self) -> None:
        """Drop the staging holds of clones that admission has adopted
        (their blocks' refcounts are bumped, so nothing a queued clone
        needs is dropped)."""
        for rid in [r for r, d in self._dreqs.items()
                    if r in self._staged
                    and d.state is not RequestState.WAITING]:
            self.dec.alloc.free(self._staged.pop(rid))

    # ---------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, object]:
        """The decode engine's metrics (clones keep the original arrival,
        so arrival-to-done spans cover both roles), plus per-role and
        handoff attribution."""
        m = dict(self.dec.metrics())
        pre_m = self.pre.metrics()
        role_keys = ("steps", "num_idle_steps", "lane_tokens_per_step",
                     "output_tokens", "finished", "preemptions",
                     "prefix_hits", "prefix_misses", "backend", "overlap",
                     "phase_s", "tier")
        m["roles"] = {
            "prefill": {**{k: pre_m[k] for k in role_keys},
                        "prefills_completed": self.num_handoffs},
            "decode": {**{k: m[k] for k in role_keys},
                       "direct_submits": self.num_direct},
        }
        m["handoffs"] = self.num_handoffs
        m["handoff_ms"] = {k: (v * 1e3 if k != "n" else v)
                           for k, v in self.handoff.summary().items()}
        m["policy_counters"] = dict(m["policy_counters"])
        m["policy_counters"].update(
            {f"tier.prefill.{k}": v
             for k, v in sorted(pre_m["tier"].items())
             if k in ("demotes", "promotes", "hits", "drops")})
        m["role"] = "prefill,decode"
        return m
