"""Scheduler-driven serving engine over the paged KV cache (port of the
single-device paths of ``repro.serving.engine``).

Each :meth:`ServingEngine.step` schedules on the host
(:mod:`repro_torch.serving.scheduler`), renders the plan into flat token
lanes plus BlockList and ragged metadata (:meth:`_render`, the reference's
power-of-two lane and slot buckets, so the host arrays match the
reference's exactly), runs ONE fused forward (``decode_tokens_paged``: per
layer a hand-written paged-attention kernel on a card) and samples
(:meth:`_build`), then commits the sampled tokens (:meth:`_resolve`).

* ``ServeConfig.overlap``: :meth:`_build` of step n+1 is dispatched before
  :meth:`_resolve` of step n.  A decode lane whose input token is still on
  the device takes it from step n's sampled tensor (``tok_src``), the
  step's small host arrays are uploaded from pinned memory without waiting,
  and nothing in the build half reads a device value on the host.
* ``ServeConfig.spec`` (a registered proposer of
  :mod:`repro_torch.serving.spec`): drafted requests carry their last token
  plus up to ``spec_k`` drafts through the same forward, which returns a
  logit row per lane (``logit_lanes``); :func:`verify_batched` keeps the
  longest accepted prefix and the rejected tail's blocks are rolled back.
  Drafted steps are synchronous (:meth:`_step_sync`): the overlapped loop
  resolves its pending step first.

* ``ServeConfig.host_blocks > 0``: the host-memory KV tier.  A
  cached-free block the eviction policy lets go is demoted (its content
  read to host memory) instead of dropped, and a later prefix hit promotes
  it back into a fresh block; :meth:`sync_pools` applies this traffic in
  order, before the copy-on-write copies.
* ``role="prefill"``: a prefill-only engine for disaggregated serving
  (:mod:`repro_torch.serving.disagg`).  A request whose last prompt chunk
  commits is parked, its blocks live, until :meth:`take_prefilled` hands
  it to the frontend.

``ServeConfig.attn_impl`` picks the attention kernel of every layer:
``"ragged"`` (the default) or ``"chunked"`` (tuned by ``q_chunk`` and
``prefetch_depth``).  Greedy streams are identical under either kernel at
an equal decode split, with overlap on or off, and with or without a
proposer or the host tier.

The kernels' tunables (``num_queries_per_block``,
``num_kv_pages_per_block``, ``vmem_limit_bytes``) resolve as the
reference's do: a value > 0 in the config wins; with ``attn_impl="ragged"``
and any left at 0 the engine consults the measured table
(:mod:`repro_torch.perf.autotune`) for (block size, head dim, kernel),
counting ``tune.tuned_resolved`` on a hit and ``tune.tuned_fallback`` on a
miss, and the port's defaults (``attention_api.TUNABLE_DEFAULTS``) fill
the rest.  The chunked kernel takes the resolved split and cap too.

``ServeConfig.sanitize`` runs the guards of
:mod:`repro_torch.analysis.sanitize`: the retrace guard around each
forward's dispatch, the host-sync guard around the build half, and the
allocator's invariants after every commit; ``metrics()["sanitize"]`` and
the ``sanitize.*`` counters report them.

A mesh (``mesh=`` a :class:`repro_torch.launch.mesh.Mesh`, or
``ServeConfig.devices > 1``, which builds one with ``make_serving_mesh``)
runs the same engine mesh-native on S ranks, one process each: the params
are this rank's shard by the reference's ``ShardingRules`` (``head_dim``
set), the fused pool this rank's block of ``NB / S`` blocks (NB rounded up
to a multiple of S; the allocator's free list interleaves the shards),
and each step's BlockList the per-shard LOCAL lists
(``build_sharded_block_lists``, the drafted owners included) of which the
forward takes this rank's row; every layer log-sum-exp-combines the
ranks' attention partials (``TransformerLM.decode_tokens_paged``).  Every
rank runs this host program on the same inputs and draws from the same
seeded generator over the same combined logits, so the ranks' streams
agree, and greedy streams are the single-device engine's.  A
copy-on-write pair across ranks moves its block over the axis
(``paged_kv.copy_pool_blocks_sharded``).  ``metrics()`` reports
``backend == "sharded"``, ``devices`` and ``mesh_shape``.  A MoE config
runs its experts split over the ranks (each rank its experts over every
lane at full capacity, one float32 SUM: ``layers.moe``).  Refused with a
mesh, as the reference refuses it: the host tier (``ValueError``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.analysis import sanitize as sanitize_lib
from repro_torch.config import ModelConfig, ServeConfig
from repro_torch.core import attention_api
from repro_torch.core import paged_kv
from repro_torch.core.paged_kv import (
    BlockAllocator, HostPool, copy_pool_blocks, make_fused_pool,
    read_pool_block, write_pool_block)
from repro_torch.perf import autotune as autotune_lib
from repro_torch.perf import spans
from repro_torch.serving import policy as policy_lib
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving import spec as spec_lib
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.request import (
    Request, RequestState, SamplingParams, bucket_pow2)
from repro_torch.serving.scheduler import Scheduler, StepPlan

__all__ = ["Request", "RequestState", "SamplingParams", "ServingEngine"]


class _PendingStep:
    """One dispatched, not yet resolved step: its actions ``(kind, req, n,
    pos0, out_idx)`` (``out_idx`` the placeholder in ``req.output``, None
    for a chunk-only prefill), the slots at build time, the requests whose
    input token the next step chains from it, and the sampled tokens
    (still on the device).  A request finished by an earlier resolve is
    ``cancelled``: its action is skipped and its placeholder popped."""

    __slots__ = ("actions", "slots", "chain", "nxt_dev", "cancelled",
                 "phases", "num_tokens", "t_dispatch", "step")

    def __init__(self, *, actions, slots, chain, nxt_dev, phases,
                 num_tokens, t_dispatch, step):
        self.actions = actions
        self.slots = slots
        self.chain = chain
        self.nxt_dev = nxt_dev
        self.cancelled: set = set()
        self.phases = phases
        self.num_tokens = num_tokens
        self.t_dispatch = t_dispatch
        self.step = step                # the span step id (None: off)

    def cancel(self, req: Request) -> None:
        rid = req.req_id
        for _, r, _, _, out_idx in self.actions:
            if r.req_id == rid:
                self.cancelled.add(rid)
                if out_idx is not None:
                    assert out_idx == len(req.output) - 1, (rid, out_idx)
                    req.output.pop()
                return


def _refuse(serve: ServeConfig, mesh, role: str) -> None:
    if mesh is not None and not hasattr(mesh, "axis_index"):
        raise TypeError(f"mesh {mesh!r}: expected a repro_torch.launch.mesh"
                        ".Mesh")
    if role not in ("full", "prefill"):
        raise ValueError(f"unknown engine role {role!r}")
    if serve.attn_impl not in ("ragged", "chunked"):
        raise ValueError(f"attn_impl {serve.attn_impl!r}: expected 'ragged' "
                         "or 'chunked'")


class ServingEngine:
    def __init__(self, model, params, cfg: ModelConfig, serve: ServeConfig,
                 *, num_blocks: Optional[int] = None, eos_id: int = -1,
                 token_budget: Optional[int] = None, seed: int = 0,
                 admission=None, preemption=None, eviction=None,
                 proposer=None, mesh=None, role: str = "full",
                 device="cuda"):
        _refuse(serve, mesh, role)
        if mesh is None and serve.devices > 1:
            from repro_torch.launch.mesh import make_serving_mesh
            mesh = make_serving_mesh(model=serve.devices)
        self.mesh = mesh
        self.mesh_axis = serve.parallel.model_axis
        S = mesh.size(self.mesh_axis) if mesh is not None else 1
        self.shards = S
        self.rank = mesh.axis_index(self.mesh_axis) if mesh is not None else 0
        self.cow_moves = 0      # copy-on-write pairs moved across ranks
        self.device = device_lib.resolve(device)
        self.model = model
        self.cfg = cfg
        self.serve = serve
        self.eos_id = eos_id
        # a prefill-role engine parks a request whose last prompt chunk
        # commits (state PREFILLING, blocks live) for take_prefilled()
        self.role = role
        self.prefill_only = role == "prefill"
        self.prefilled: List[Request] = []
        bs = serve.kv_block_size
        nb = num_blocks or serve.max_blocks or serve.max_batch * 64
        nb = -(-nb // S) * S            # the pool splits into equal shards
        a = cfg.attention
        adm, pre, evi = policy_lib.resolve_triple(
            admission=admission, preemption=preemption, eviction=eviction,
            config=serve)
        self.policies = {p.axis: p.name for p in (adm, pre, evi)}
        self._policy_objs = (adm, pre, evi)
        self.alloc = BlockAllocator(num_blocks=nb, block_size=bs,
                                    num_shards=S, eviction_policy=evi)
        self.host_pool: Optional[HostPool] = None
        if serve.host_blocks > 0:
            if S > 1:
                raise ValueError(
                    "host KV tier requires an unsharded pool (the demote/"
                    "promote block copies assume single-device block "
                    "slices)")
            self.host_pool = HostPool(serve.host_blocks)
            self.alloc.host_pool = self.host_pool
        # this rank's block of the sequence-sharded pool (all of it on one
        # device)
        self.pools = {"kv": make_fused_pool(
            cfg.num_layers, nb // S, bs, a.num_kv_heads, a.head_dim,
            model.dtype, self.device)}
        if mesh is not None:
            params = model.shard_params(params, mesh, self.mesh_axis)
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
        self._metrics = EngineMetrics(
            backend="sharded" if mesh is not None else kernel)
        # The kernels' tunables: an explicit value > 0 wins; with the
        # ragged kernel and any left at 0, the measured table for this
        # (block size, head dim, kernel) cell, counted tuned_resolved /
        # tuned_fallback; the port's defaults fill the rest.
        defaults = dict(attention_api.TUNABLE_DEFAULTS)
        self._tune_counters = {"tuned_resolved": 0, "tuned_fallback": 0}
        explicit = {k: int(getattr(serve, k))
                    for k in autotune_lib.TUNABLE_KEYS}
        if self.attn_impl == "ragged" and any(
                v == 0 for v in explicit.values()):
            tuned = autotune_lib.resolve_tunables(bs, a.head_dim, kernel)
            if tuned is not None:
                defaults.update(tuned)
                self._tune_counters["tuned_resolved"] = 1
            else:
                self._tune_counters["tuned_fallback"] = 1
        # (a negative value is refused here, not read as "unset")
        self.attn_tunables = attention_api.check_tunables(
            bs, a.num_heads // a.num_kv_heads,
            **{k: explicit[k] if explicit[k] != 0 else int(defaults[k])
               for k in autotune_lib.TUNABLE_KEYS})
        # Runtime sanitizers: the retrace guard on each forward's dispatch,
        # the host-sync guard around the build half, and the allocator's
        # invariants after every commit.
        self.sanitize = bool(serve.sanitize)
        self.sanitizer = (sanitize_lib.Sanitizer() if self.sanitize
                          else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # overlapped loop: the dispatched, unresolved step, and req_id ->
        # its slot in that step's sampled tensor for requests whose last
        # output token is still on the device
        self.overlap = bool(serve.overlap)
        self._pending: Optional[_PendingStep] = None
        self._chain: Dict[int, int] = {}
        self.proposer = spec_lib.resolve(proposer, config=serve.spec)
        if (self.proposer is not None
                and not getattr(self.proposer, "deterministic", True)):
            raise ValueError(
                f"proposer {self.proposer.name!r} declares "
                "deterministic=False: verify_batched's delta-q rejection "
                "rule assumes the draft distribution is a point mass")
        self.spec_k = max(1, serve.spec_k) if self.proposer else 0
        self._spec_counters = {"steps": 0, "drafted_steps": 0,
                               "decode_lanes": 0, "proposed_tokens": 0,
                               "accepted_tokens": 0, "emitted_tokens": 0,
                               "rollback_blocks": 0}
        if self.proposer is not None:
            self.proposer.bind(self)

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
        spans.mark(req.req_id, "submit")

    @property
    def waiting(self) -> List[Request]:
        return list(self.scheduler.waiting)

    @property
    def active(self) -> Dict[int, Request]:
        return self.scheduler.running

    # ------------------------------------------------------------- step build
    def _render(self, plan: StepPlan):
        """Render a StepPlan into host (numpy) arrays: ``(lists, tokens,
        tok_src, (temps, top_ks, top_ps), spec, committed)``, ``spec`` the
        ``(drafts, draft_lens)`` of a drafted plan, else None.  Reserves
        this step's KV slots in the allocator (copy-on-write included).

        Attention reads its keys by owner.  A prefill chunk or an undrafted
        decode lane is one owner, its slot, as in the reference.  Each lane
        of a drafted request is an owner of its own (lane 0 its slot, the
        others the ids past ``Bs``), holding the request's pages up to its
        position: so every verify lane runs the single-lane (decode) tile
        on exactly the inputs the draftless engine's decode of that token
        has, and the greedy streams stay those of the draftless engine in
        bf16 too.  Without drafts the arrays are the reference's; with a
        mesh the BlockList arrays are the (S, M) per-shard local lists, as
        the reference renders them."""
        alloc, B = self.alloc, self.B
        T = bucket_pow2(plan.num_tokens)
        reqs = list(plan.decode) + [req for req, _ in plan.prefill]
        Bs = min(bucket_pow2(1 + max(req.slot for req in reqs)), B)
        spec_step = bool(plan.spec)
        R = self.spec_k + 1 if spec_step else 1         # logit rows per slot
        tokens = np.zeros((T,), np.int32)
        # tok_src[lane] >= 0: the lane's input token is the pending step's
        # sampled token at that slot, still on the device; -1: host-known
        tok_src = np.full((T,), -1, np.int32)
        token_pos = np.zeros((T,), np.int32)
        slots = np.full((T, 2), (self.max_total, 0), np.int32)  # dropped
        last_lane = np.zeros((Bs,), np.int32)
        temps = np.zeros((Bs,), np.float32)
        top_ks = np.zeros((Bs,), np.int32)
        top_ps = np.ones((Bs,), np.float32)
        logit_lanes = np.zeros((Bs, R), np.int32)
        draft_tokens = np.zeros((Bs, max(R - 1, 1)), np.int32)
        draft_lens = np.zeros((Bs,), np.int32)
        lane = 0
        committed: List[tuple] = []             # (req, n_tokens, start_pos)
        for req in plan.decode:
            rid = req.req_id
            pos = alloc.seq_len(rid)
            draft = plan.spec.get(rid)
            n = 1 if draft is None else 1 + len(draft)
            ss = alloc.reserve_tokens(rid, n)
            src = self._chain.get(rid, -1)
            if src >= 0:                        # drafted steps never chain
                assert draft is None, rid
                tok_src[lane] = src
            else:
                tokens[lane] = req.output[-1]
            if n > 1:                           # drafted lanes ride behind
                tokens[lane + 1:lane + n] = draft
                draft_tokens[req.slot, :n - 1] = draft
                draft_lens[req.slot] = n - 1
            token_pos[lane:lane + n] = pos + np.arange(n)
            slots[lane:lane + n] = ss
            last_lane[req.slot] = lane + n - 1
            # a row per lane; unused rows repeat the last lane
            logit_lanes[req.slot] = np.minimum(lane + np.arange(R),
                                               lane + n - 1)
            lane += n
            committed.append((req, n, pos))
        for req, n in plan.prefill:
            pos0 = alloc.seq_len(req.req_id)
            ss = alloc.reserve_tokens(req.req_id, n)
            tokens[lane:lane + n] = req.active_prompt[pos0:pos0 + n]
            token_pos[lane:lane + n] = pos0 + np.arange(n)
            slots[lane:lane + n] = ss
            last_lane[req.slot] = lane + n - 1
            logit_lanes[req.slot] = lane + n - 1        # only row 0 is read
            lane += n
            committed.append((req, n, pos0))
        for req, _, _ in committed:
            temps[req.slot] = req.sampling.temperature
            top_ks[req.slot] = req.sampling.top_k
            top_ps[req.slot] = req.sampling.top_p
        # Attention owners in lane order, (owner, lanes, keys, pages), from
        # the tables AFTER reservations (they may have grown / CoW'd).
        bs = alloc.block_size
        owners = []
        extra = Bs
        for req, n, pos0 in committed:
            table = alloc.table(req.req_id)
            if req.req_id in plan.spec and req.state is RequestState.DECODING:
                for k in range(n):
                    keys = pos0 + k + 1
                    owners.append((req.slot if k == 0 else extra, 1, keys,
                                   table[:-(-keys // bs)]))
                    extra += k > 0
            else:
                owners.append((req.slot, n, pos0 + n, table))
        O = extra                               # owners; O == padding owner
        token_req = np.full((T,), O, np.int32)
        kv_lens = np.zeros((O,), np.int32)
        # shared prefix blocks count once per holder, so the BlockList's
        # capacity grows past the pool size by power-of-two buckets
        needed = sum(len(pages) for *_, pages in owners)
        cap = (self.max_total if needed <= self.max_total
               else bucket_pow2(needed, lo=self.max_total))
        bl = np.zeros((cap,), np.int32)
        br = np.full((cap,), O, np.int32)
        bp = np.zeros((cap,), np.int32)
        # Ragged metadata: one contiguous lane run per owner, in lane order.
        q_lens = np.zeros((O,), np.int64)
        kv_l = np.zeros((O,), np.int64)
        seq_slot = np.full((O,), O, np.int32)           # O == dropped entry
        cursor = lane = 0
        for j, (owner, n, keys, pages) in enumerate(owners):
            token_req[lane:lane + n] = owner
            kv_lens[owner] = keys
            bl[cursor:cursor + len(pages)] = pages
            br[cursor:cursor + len(pages)] = owner
            bp[cursor:cursor + len(pages)] = np.arange(len(pages))
            seq_slot[j], q_lens[j], kv_l[j] = owner, n, keys
            cursor += len(pages)
            lane += n
        cu_q = np.zeros((O + 1,), np.int32)
        cu_kv = np.zeros((O + 1,), np.int32)
        cu_q[1:] = np.cumsum(q_lens)
        cu_kv[1:] = np.cumsum(kv_l)
        if self.mesh is not None:
            # the per-shard LOCAL lists (S, M) of the same owners: every
            # rank attends against the row its pool shard serves
            bl, br, bp = paged_kv.shard_block_lists(
                [(owner, pages) for owner, _, _, pages in owners],
                alloc.num_shards, alloc.blocks_per_shard, pad_req=O)
        lists = {
            "block_list": bl, "block_req": br, "block_pos": bp,
            "kv_lens": kv_lens, "token_req": token_req,
            "token_pos": token_pos, "cu_q_lens": cu_q, "cu_kv_lens": cu_kv,
            "seq_slot": seq_slot, "slots": slots, "last_lane": last_lane,
        }
        if spec_step:
            lists["logit_lanes"] = logit_lanes
        spec = (draft_tokens, draft_lens) if spec_step else None
        if spans.active() is not None:
            # a request's first prefill lanes: the first after its first
            # admission (none for one admitted before the recording)
            for req, _, _ in committed:
                if req.state is RequestState.PREFILLING:
                    spans.mark(req.req_id, "first_lanes", after="admit")
        return (lists, tokens, tok_src, (temps, top_ks, top_ps), spec,
                committed)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device.  On a card it is staged in
        pinned memory and copied without waiting; PyTorch's pinned-memory
        cache keeps the staging buffer until that copy has run."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _uploads(self, arrays):
        return type(arrays)(self._upload(a) for a in arrays)

    # ------------------------------------------------------------- sanitizers
    def _sanitize_scope(self, scope: str):
        """The host-sync guard over the build half (none unless
        sanitizing)."""
        if self.sanitizer is None:
            return contextlib.nullcontext()
        return self.sanitizer.no_host_sync(scope)

    def _expect_cached(self, tag: str, *trees):
        """The retrace guard around one forward's dispatch (none unless
        sanitizing)."""
        if self.sanitizer is None:
            return contextlib.nullcontext()
        return self.sanitizer.expect_cached(
            sanitize_lib.jit_signature(tag, *trees))

    def _check_allocator(self) -> None:
        if self.sanitizer is not None:
            self.sanitizer.check_allocator(self.alloc)

    # -------------------------------------------------------------- main loop
    def _propose(self) -> Dict[int, np.ndarray]:
        """Drafts for every DECODING request, through ONE ``propose_batch``
        call; each is clamped so the step cannot emit past
        ``max_new_tokens``."""
        pend = [(req, min(self.spec_k,
                          req.max_new_tokens - len(req.output) - 1))
                for req in self.scheduler.running.values()
                if req.state is RequestState.DECODING
                and len(req.output) < req.max_new_tokens]
        if not pend:
            return {}
        raw = self.proposer.propose_batch(pend)
        drafts: Dict[int, np.ndarray] = {}
        for req, _ in pend:
            d = raw.get(req.req_id)
            d = (np.zeros((0,), np.int32) if d is None
                 else np.asarray(d, np.int32))
            self.proposer.on_propose(req, len(d))
            if len(d):
                drafts[req.req_id] = d
        return drafts

    def step(self) -> int:
        """One engine iteration: [propose] + schedule + ONE fused forward
        (with verify on a drafted step) + the host-side commit.  Returns the
        number of lanes run.  With overlap on, this step is dispatched
        before the previous one is resolved.

        With spans on (:mod:`repro_torch.perf.spans`) the step is the
        ``engine.step`` span, around ``engine.propose``,
        ``engine.schedule``, ``engine.render``, ``engine.pool_sync``,
        ``engine.dispatch``, ``engine.wait`` and ``engine.commit`` (the
        last two carry the id of the step they resolve), and the
        allocator's and scheduler's counters are read before and after."""
        spans.follow_profiler()
        self._read_counters()
        with spans.span("engine.step", step=spans.next_step()):
            n = self._step()
        self._read_counters()
        return n

    def _read_counters(self) -> None:
        if spans.active() is None:
            return
        alloc = self.alloc
        for name, value in (
                ("alloc.cache_evictions", alloc.cache_evictions),
                ("prefix_hits", alloc.prefix_hits),
                ("prefix_misses", alloc.prefix_misses),
                ("cow_copies", alloc.cow_copies),
                ("scheduler.num_preemptions",
                 self.scheduler.num_preemptions)):
            spans.gauge(name, value)

    def _step(self) -> int:
        t0 = time.perf_counter()
        if self.proposer is not None and self._pending is not None:
            # proposers read the tail of req.output: resolve its
            # placeholders first (drafted steps are barriers anyway)
            pend, self._pending = self._pending, None
            self._resolve(pend, None)
            if not self.scheduler.has_work():
                return 0                # that resolve finished the last ones
        with spans.span("engine.propose"):
            drafts = self._propose() if self.proposer is not None else {}
        t1 = time.perf_counter()
        with spans.span("engine.schedule"):
            plan = self.scheduler.schedule(spec_drafts=drafts)
        if plan.num_tokens == 0:
            if self._pending is not None:      # drain the in-flight step
                pend, self._pending = self._pending, None
                pend.phases["propose"] += t1 - t0
                self._resolve(pend, None)
                return 0
            self._metrics.record_step(
                num_tokens=0, emitted_tokens=0, idle=True,
                phases={"propose": t1 - t0,
                        "idle": time.perf_counter() - t1})
            return 0
        if plan.spec:
            # a drafted step commits KV later lanes depend on and rolls
            # blocks back: resolve the pipeline first, then drop the plan
            # entries of requests that resolve finished
            if self._pending is not None:
                pend, self._pending = self._pending, None
                self._resolve(pend, None)
                self._filter_finished(plan)
                if plan.num_tokens == 0:
                    return 0
            return self._step_sync(plan, t0, t1)
        pend_new = self._build(plan, t0, t1)
        prev, self._pending = self._pending, None
        if prev is not None:
            self._resolve(prev, pend_new)
        if self.overlap:
            self._pending = pend_new
        else:
            self._resolve(pend_new, None)
        return plan.num_tokens

    def _drain_cow(self) -> None:
        """Apply pending copy-on-write block copies to the device pool."""
        copies = self.alloc.drain_copies()
        if copies:
            srcs = np.asarray([s for s, _ in copies], np.int64)
            dsts = np.asarray([d for _, d in copies], np.int64)
            if self.mesh is not None:
                per = self.alloc.blocks_per_shard
                self.cow_moves += int(np.sum(srcs // per != dsts // per))
            for p in self.pools.values():
                if self.mesh is not None:
                    paged_kv.copy_pool_blocks_sharded(
                        p, srcs, dsts, self.mesh,
                        self.alloc.blocks_per_shard, self.mesh_axis)
                else:
                    copy_pool_blocks(p, srcs, dsts)

    def _drain_tier(self) -> None:
        """Apply the queued host-tier traffic to the device pool, in order.

        A demote reads its block to host memory before anything can reuse
        the block (a deliberate sync: the read waits for the steps that
        wrote it); a promote writes a saved copy into its fresh block.
        Runs before the CoW drain, whose destinations may be reused demoted
        blocks."""
        channels = sorted(self.pools)
        for kind, entry, blk in self.alloc.drain_tier_ops():
            if kind == "demote":
                entry.data = tuple(read_pool_block(self.pools[c], blk)
                                   for c in channels)
            else:
                assert entry.data is not None, "promote before demote copy"
                for c, val in zip(channels, entry.data):
                    write_pool_block(self.pools[c], blk, val)

    def sync_pools(self) -> None:
        """Flush allocator-queued device-pool traffic: tier ops, then CoW.
        Public because the disaggregation frontend flushes the decode pool
        before it writes handed-off KV into freshly reserved slots."""
        with spans.span("engine.pool_sync"):
            self._drain_tier()
            self._drain_cow()

    def _rank_lists(self, lists_np, num_lanes: int):
        """This rank's view of rendered lists: its row of the sharded
        BlockList, and in place of ``slots`` the lanes whose block it
        holds (``own_lanes``) at their local slots (``own_slots``)."""
        r, per = self.rank, self.alloc.blocks_per_shard
        out = dict(lists_np)
        for k in ("block_list", "block_req", "block_pos"):
            out[k] = np.ascontiguousarray(lists_np[k][r])
        slots = out.pop("slots")[:num_lanes]
        own = np.nonzero(slots[:, 0] // per == r)[0].astype(np.int32)
        out["own_lanes"] = own
        out["own_slots"] = paged_kv.local_slots(slots[own], r, per)
        return out

    def _forward(self, plan: StepPlan, lists_np, tokens: torch.Tensor,
                 tag: str = "step"):
        """Upload the rendered lists and run the fused forward (``tag``
        names the dispatch to the retrace guard)."""
        mesh_kw = {}
        sig = lists_np
        if self.mesh is not None:
            lists_np = self._rank_lists(lists_np, plan.num_tokens)
            mesh_kw = dict(mesh=self.mesh, axis=self.mesh_axis)
        lists = {k: self._upload(v) for k, v in lists_np.items()}
        with self._expect_cached(tag, sig, tokens):
            logits, self.pools = self.model.decode_tokens_paged(
                self.params, self.pools, lists, tokens,
                num_lanes=plan.num_tokens, attn_impl=self.attn_impl,
                q_chunk=self.q_chunk, prefetch_depth=self.prefetch_depth,
                attn_tunables=self.attn_tunables, **mesh_kw)
        return logits

    def _build(self, plan: StepPlan, t0: float, t1: float) -> _PendingStep:
        """Render + dispatch a draftless plan and commit it provisionally:
        KV slots are committed, decode-ish actions append a placeholder
        token (the sampled value is still on the device) recorded in
        ``_chain``, prefill chunks advance and publish their prefix blocks.
        Nothing here waits for the device (the host-sync guard holds the
        render, the pool traffic and the dispatch to that when
        sanitizing)."""
        with self._sanitize_scope("overlap-build"):
            with spans.span("engine.render"):
                (lists_np, tokens_np, tok_src_np, sample_np, spec,
                 committed) = self._render(plan)
            assert spec is None, "drafted plans go through _step_sync"
            self.sync_pools()
            t2 = time.perf_counter()
            with spans.span("engine.dispatch"):
                tokens = self._upload(tokens_np)
                if (tok_src_np >= 0).any():  # chain from the step in flight
                    nxt_prev = self._pending.nxt_dev
                    tok_src = self._upload(tok_src_np)
                    live = tok_src.clamp(0, nxt_prev.shape[0] - 1).long()
                    tokens = torch.where(tok_src >= 0, nxt_prev[live],
                                         tokens)
                logits = self._forward(plan, lists_np, tokens)
                nxt_dev = sampling_lib.sample_batched(
                    self._gen, logits, *self._uploads(sample_np))
        actions = []
        chain: Dict[int, int] = {}
        for req, n, pos0 in committed:
            rid = req.req_id
            self.alloc.commit_tokens(rid, n)
            if req.state is RequestState.DECODING:
                req.output.append(0)            # placeholder: value in flight
                chain[rid] = req.slot
                actions.append(("decode", req, n, pos0, len(req.output) - 1))
            else:                               # prefill chunk
                start = req.prefill_pos
                req.prefill_pos += n
                self.alloc.register_prefix(rid, req.active_prompt,
                                           req.prefill_pos, start=start)
                out_idx = None
                if req.prefill_remaining == 0:  # final chunk samples a token
                    if self.prefill_only:
                        # parked for the handoff: no token sampled; the
                        # decode engine recomputes the last position
                        self.prefilled.append(req)
                    else:
                        req.to_state(RequestState.DECODING)
                        req.output.append(0)
                        chain[rid] = req.slot
                        out_idx = len(req.output) - 1
                actions.append(("prefill", req, n, pos0, out_idx))
        self._chain = chain
        if self.proposer is not None:
            self._spec_counters["steps"] += 1
        return _PendingStep(
            actions=actions,
            slots={req.req_id: req.slot for req, _, _ in committed},
            chain=chain, nxt_dev=nxt_dev,
            phases={"propose": t1 - t0, "schedule_render": t2 - t1},
            num_tokens=plan.num_tokens, t_dispatch=t2,
            step=spans.current_step())

    def _resolve(self, pend: _PendingStep,
                 next_pending: Optional[_PendingStep]) -> None:
        """Wait for a pending step's sampled tokens and reconcile:
        placeholders become tokens, EOS / max_new_tokens finishes fire
        (cancelling the request's action in ``next_pending``), a request
        preempted mid-flight keeps its token for the recompute, and the
        step's metrics are recorded.  Its ``device`` phase (the
        reference's key) is the host's time from the dispatch's start to
        the tokens in host memory: the enqueue of the forward and the
        sampling, then the wait for the card (the ``engine.dispatch`` and
        ``engine.wait`` spans), not device time."""
        with spans.span("engine.wait", step=pend.step):
            nxt = pend.nxt_dev.cpu().numpy()    # waits for the step
        with spans.span("engine.commit", step=pend.step):
            self._reconcile(pend, next_pending, nxt)
        # after the reconciliation: commits, finishes and preemption frees
        # have all landed in the allocator
        self._check_allocator()

    def _reconcile(self, pend: _PendingStep,
                   next_pending: Optional[_PendingStep],
                   nxt: np.ndarray) -> None:
        t_done = time.perf_counter()
        if self._chain is pend.chain:           # nothing newer in flight
            self._chain = {}
        now = time.time()
        emitted = 0
        for kind, req, n, pos0, out_idx in pend.actions:
            rid = req.req_id
            if rid in pend.cancelled or out_idx is None:
                continue        # finished at an earlier resolve / chunk-only
            tok = int(nxt[pend.slots[rid]])
            req.output[out_idx] = tok
            emitted += 1
            preempted = req.state is RequestState.PREEMPTED
            if kind == "decode" and not preempted:
                self._register_generated(req, pos0, new_len=pos0 + n)
            if kind == "prefill" and req.first_token_at is None:
                req.first_token_at = now
            # out_idx + 1: the output length through THIS action (the next
            # step's placeholder may already follow it)
            if out_idx + 1 >= req.max_new_tokens or tok == self.eos_id:
                self._finish(req, now, next_pending=next_pending)
        self._metrics.record_step(
            num_tokens=pend.num_tokens, emitted_tokens=emitted,
            phases={**pend.phases, "device": t_done - pend.t_dispatch,
                    "commit": time.perf_counter() - t_done})

    def _filter_finished(self, plan: StepPlan) -> None:
        """Drop plan entries whose request finished at a resolve that ran
        after the plan was scheduled."""
        plan.decode = [r for r in plan.decode
                       if r.state is RequestState.DECODING]
        live = {r.req_id for r in plan.decode}
        plan.spec = {rid: d for rid, d in plan.spec.items() if rid in live}
        plan.prefill = [(r, n) for r, n in plan.prefill
                        if r.state is RequestState.PREFILLING]

    def _step_sync(self, plan: StepPlan, t0: float, t1: float) -> int:
        """The drafted step, synchronous: one forward with a logit row per
        lane, ``verify_batched``, the accepted prefix committed and the
        rejected tail's blocks rolled back."""
        with spans.span("engine.render"):
            lists_np, tokens_np, _, sample_np, spec, committed = (
                self._render(plan))
        assert spec is not None
        self.sync_pools()
        t2 = time.perf_counter()
        with spans.span("engine.dispatch"):
            logits = self._forward(plan, lists_np, self._upload(tokens_np),
                                   "spec")
            out, acc = spec_lib.verify_batched(
                self._gen, logits, *self._uploads(spec),
                *self._uploads(sample_np))
        with spans.span("engine.wait"):
            out, acc = out.cpu().numpy(), acc.cpu().numpy()
        with spans.span("engine.commit"):
            self._commit_verified(plan, committed, out, acc, t0, t1, t2)
        self._check_allocator()
        return plan.num_tokens

    def _commit_verified(self, plan: StepPlan, committed, out: np.ndarray,
                         acc: np.ndarray, t0: float, t1: float,
                         t2: float) -> None:
        """A drafted step's commit: the accepted prefix of each decode
        lane, the rejected tail's blocks rolled back, prefill chunks
        advanced, and the step's metrics recorded."""
        nxt = out[:, 0]
        t3 = time.perf_counter()
        now = time.time()
        emitted = 0
        for req, n, _ in committed:
            if req.state is RequestState.DECODING:
                a = min(int(acc[req.slot]), n - 1)
                self.alloc.commit_tokens(req.req_id, 1 + a)
                if a < n - 1:
                    before = len(self.alloc.table(req.req_id))
                    self.alloc.truncate(req.req_id,
                                        self.alloc.seq_len(req.req_id))
                    self._spec_counters["rollback_blocks"] += (
                        before - len(self.alloc.table(req.req_id)))
            else:
                self.alloc.commit_tokens(req.req_id, n)
        for req, n, pos0 in committed:
            if req.state is RequestState.DECODING:
                a = min(int(acc[req.slot]), n - 1)
                row = out[req.slot]
                self._register_generated(req, pos0, accepted=row[:a])
                appended = 0
                for j in range(a + 1):
                    self._append_token(req, int(row[j]), now)
                    appended += 1
                    if req.state is RequestState.FINISHED:
                        break               # EOS inside the accepted run
                emitted += appended
                if n > 1:       # drafted lanes only, tokens that landed
                    self._spec_counters["decode_lanes"] += 1
                    self._spec_counters["accepted_tokens"] += min(
                        a, appended)
                    self._spec_counters["emitted_tokens"] += appended
            else:                                       # prefill chunk
                start = req.prefill_pos
                req.prefill_pos += n
                self.alloc.register_prefix(req.req_id, req.active_prompt,
                                           req.prefill_pos, start=start)
                if req.prefill_remaining == 0:
                    if self.prefill_only:
                        self.prefilled.append(req)
                        continue
                    req.to_state(RequestState.DECODING)
                    if req.first_token_at is None:
                        req.first_token_at = now
                    self._append_token(req, int(nxt[req.slot]), now)
                    emitted += 1
        self._spec_counters["steps"] += 1
        self._spec_counters["drafted_steps"] += 1
        self._spec_counters["proposed_tokens"] += sum(
            len(d) for d in plan.spec.values())
        t4 = time.perf_counter()
        self._metrics.record_step(
            num_tokens=plan.num_tokens, emitted_tokens=emitted,
            phases={"propose": t1 - t0, "schedule_render": t2 - t1,
                    "device": t3 - t2, "commit": t4 - t3})

    def _register_generated(self, req: Request, pos0: int,
                            accepted: Optional[np.ndarray] = None,
                            new_len: Optional[int] = None) -> None:
        """Hash-register full KV blocks filled by this step's decode tokens
        (``accepted``: a drafted step's accepted drafts, not yet appended;
        ``new_len``: the post-step length, which the overlapped resolve
        passes because the allocator may hold the next step's commits)."""
        if new_len is None:
            new_len = self.alloc.seq_len(req.req_id)
        bs = self.alloc.block_size
        if pos0 // bs == new_len // bs:         # no block filled this step
            return
        seq = req.resume_tokens()
        if accepted is not None and len(accepted):
            seq = np.concatenate([seq, np.asarray(accepted, np.int32)])
        self.alloc.register_prefix(req.req_id, seq, new_len, start=pos0)

    def _append_token(self, req: Request, tok: int, now: float) -> None:
        req.output.append(tok)
        if len(req.output) >= req.max_new_tokens or tok == self.eos_id:
            self._finish(req, now)

    def _finish(self, req: Request, now: float,
                next_pending: Optional[_PendingStep] = None) -> None:
        if req.state is RequestState.PREEMPTED:
            # finished at a resolve after its preemption: its blocks are
            # already free; take it out of the recompute queue
            try:
                self.scheduler.waiting.remove(req)
            except ValueError:
                pass
        else:
            self.scheduler.release(req)
        req.finish(now)
        self.finished.append(req)
        self._metrics.record_finished(
            ttft=req.ttft, tpot=req.tpot, num_output_tokens=len(req.output),
            arrival=req.arrival, done_at=now)
        if next_pending is not None:
            next_pending.cancel(req)
        self._chain.pop(req.req_id, None)

    @property
    def busy(self) -> bool:
        """Work queued, running, or still in flight."""
        return self.scheduler.has_work() or self._pending is not None

    def take_prefilled(self) -> List[Request]:
        """Prefill role: pop the requests whose prompt KV is committed.

        Each leaves the scheduler with its blocks kept under its req_id;
        the caller hands them off, then ``alloc.free(req_id)`` releases
        this engine's copy (published blocks park cached-free, so repeated
        prompts still hit this engine's prefix cache)."""
        out, self.prefilled = self.prefilled, []
        for req in out:
            self.scheduler.detach(req)
        return out

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
            # the mesh the steps ran on (axis name -> size; None on one
            # device) and its rank count
            "mesh_shape": (dict(self.mesh.shape) if self.mesh is not None
                           else None),
            "devices": self.mesh.devices if self.mesh is not None else 1,
            "overlap": self.overlap,
            "prefetch_depth": self.prefetch_depth,
            "q_chunk": self.q_chunk,
            # the attention kernel and its resolved tunables (explicit,
            # the table's, or the defaults: the tune.* counters say which)
            "attn_impl": self.attn_impl,
            **self.attn_tunables,
            "blocks_free": self.alloc.num_free,
            "preemptions": self.scheduler.num_preemptions,
            "slot_compactions": self.scheduler.num_slot_compactions,
            "prefix_hits": hits,
            "prefix_misses": misses,
            "prefix_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            "cow_copies": self.alloc.cow_copies,
        })
        c = self._spec_counters
        m["spec"] = {
            "proposer": self.proposer.name if self.proposer else spec_lib.OFF,
            "k": self.spec_k,
            "acceptance_rate": (c["accepted_tokens"] / c["proposed_tokens"]
                                if c["proposed_tokens"] else 0.0),
            "mean_accepted_len": (c["accepted_tokens"] / c["drafted_steps"]
                                  if c["drafted_steps"] else 0.0),
            "tokens_per_decode_lane": (c["emitted_tokens"] / c["decode_lanes"]
                                       if c["decode_lanes"] else 0.0),
            "spec_sheds": self.scheduler.num_spec_sheds,
            **c,
        }
        if self.proposer is not None:
            m["spec"].update({f"proposer.{k}": v for k, v in
                              sorted(self.proposer.counters.items())})
        for axis, name in self.policies.items():
            m[f"{axis}_policy"] = name
        m["policy_counters"] = {
            f"{p.axis}.{k}": v
            for p in self._policy_objs for k, v in sorted(p.counters.items())}
        # the role and the host tier: pool sizes and the demote / promote /
        # hit / drop traffic, also flattened beside the policy counters
        m["role"] = self.role
        hp = self.host_pool
        tier_counters = (dict(hp.counters) if hp is not None else
                         {"demotes": 0, "promotes": 0, "hits": 0, "drops": 0})
        m["tier"] = {
            "hbm_blocks": self.alloc.num_blocks,
            "host_blocks": hp.capacity if hp is not None else 0,
            "host_blocks_used": len(hp) if hp is not None else 0,
            **tier_counters,
        }
        m["policy_counters"].update(
            {f"tier.{k}": v for k, v in sorted(tier_counters.items())})
        m["policy_counters"].update(
            {f"tune.{k}": v for k, v in sorted(self._tune_counters.items())})
        # the sanitizers: whether the run was guarded and their counters,
        # also flattened beside the policy counters
        san = (self.sanitizer.counters() if self.sanitizer is not None else
               {"retraces": 0, "transfer_guard_trips": 0,
                "invariant_checks": 0, "allowed_host_syncs": 0,
                "compiles": 0})
        m["sanitize"] = {"enabled": self.sanitize, **san}
        m["policy_counters"].update(
            {f"sanitize.{k}": v for k, v in sorted(san.items())})
        return m
