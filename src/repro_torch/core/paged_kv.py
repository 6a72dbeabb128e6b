"""Paged KV-cache pool and block allocator (port of ``repro.core.paged_kv``).

Host side (:class:`BlockAllocator`, :class:`HostPool`): numpy bookkeeping
with the reference's semantics — a refcounted free list over a fixed pool
of KV blocks, a prefix cache keyed by chained content hashes (cached-free
blocks keep their content for later prompts), copy-on-write of shared
blocks on append (queued as ``(src, dst)`` pairs for
:func:`copy_pool_blocks`), KV-written watermarks, the host-memory tier's
demote/promote bookkeeping, and :meth:`BlockAllocator.check_invariants`.
Which cached-free block is evicted comes from a registered eviction policy
(``repro_torch.serving.policy``).

Device side: ONE fused head-interleaved pool per layer stack,
``(L, NB, BS, 2*KV, HD)`` with K of kv-head ``k`` at row ``2k`` and its V
at ``2k+1``, for the serving engine; split K and V pools
(:func:`make_pool`) for the paper-path decode loop.  JAX's functional ``.at[].set(mode="drop")`` updates become
in-place torch writes here; the out-of-range padding slots the engine
renders are masked explicitly, because an out-of-range index on CUDA is a
memory fault, not a dropped write.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class OutOfBlocksError(RuntimeError):
    pass


@dataclass
class BlockStats:
    """Per-physical-block evidence for eviction scorers.

    ``hits``      lifetime prefix-cache adoptions of this block's content;
    ``peak_ref``  highest simultaneous refcount the block ever reached.
    Reset whenever the block is handed out for fresh content.
    """

    hits: int = 0
    peak_ref: int = 1


def _prefix_key(tokens: np.ndarray, n_tokens: int) -> bytes:
    """Content hash of ``tokens[:n_tokens]`` (chained prefix hash)."""
    buf = np.ascontiguousarray(tokens[:n_tokens], dtype=np.int32).tobytes()
    return hashlib.blake2b(buf, digest_size=16).digest()


@dataclass
class HostBlock:
    """One demoted KV block staged in host memory (``data`` is filled by
    the engine's tier drain; ``stats`` survives the round trip)."""

    key: bytes
    stats: BlockStats
    data: Optional[Tuple[np.ndarray, ...]] = None


class HostPool:
    """Host-memory KV tier: an LRU of demoted cached-free blocks.

    Capacity is counted in blocks.  ``put`` registers a demotion (oldest
    entry dropped on overflow), ``take`` consumes an entry for promotion.
    """

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"host pool capacity must be > 0, got {capacity}")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[bytes, HostBlock]" = OrderedDict()
        self.counters: Dict[str, int] = {
            "demotes": 0, "promotes": 0, "hits": 0, "drops": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def put(self, key: bytes, stats: BlockStats) -> HostBlock:
        self._entries.pop(key, None)        # re-demotion replaces stale data
        entry = HostBlock(key=key, stats=stats)
        self._entries[key] = entry
        self.counters["demotes"] += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.counters["drops"] += 1
        return entry

    def take(self, key: bytes) -> Optional[HostBlock]:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self.counters["promotes"] += 1
            self.counters["hits"] += 1
        return entry

    def untake(self, key: bytes, entry: HostBlock) -> None:
        """Roll back a ``take`` whose promotion could not get an HBM block."""
        self._entries[key] = entry
        self.counters["promotes"] -= 1
        self.counters["hits"] -= 1


@dataclass
class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` KV blocks."""

    num_blocks: int
    block_size: int
    eviction_policy: Optional[Any] = None
    host_pool: Optional[HostPool] = None
    _free: List[int] = field(default_factory=list)
    _tables: Dict[int, List[int]] = field(default_factory=dict)
    _lens: Dict[int, int] = field(default_factory=dict)
    # block -> refcount, for every live (allocated) block
    _ref: Dict[int, int] = field(default_factory=dict)
    # prefix cache: content hash <-> block (only FULL blocks)
    _hash_of: Dict[int, bytes] = field(default_factory=dict)
    _block_of: Dict[bytes, int] = field(default_factory=dict)
    # refcount-0 blocks whose content is kept for prefix reuse, oldest first
    _cached_free: "OrderedDict[int, None]" = field(default_factory=OrderedDict)
    _stats: Dict[int, BlockStats] = field(default_factory=dict)
    # block -> #leading token slots holding committed KV
    _written: Dict[int, int] = field(default_factory=dict)
    # (src, dst) copy-on-write pairs awaiting a device-pool copy
    pending_copies: List[Tuple[int, int]] = field(default_factory=list)
    # ordered host-tier traffic: ("demote"|"promote", HostBlock, block)
    pending_tier_ops: List[Tuple[str, HostBlock, int]] = field(
        default_factory=list)
    prefix_hits: int = 0
    prefix_misses: int = 0
    cow_copies: int = 0
    cache_evictions: int = 0
    blocks_allocated: int = 0

    def __post_init__(self):
        self._free = list(range(self.num_blocks - 1, -1, -1))

    # -- block bookkeeping --------------------------------------------------
    def _eviction(self) -> Any:
        """The eviction scorer, lazily resolved to the registered default."""
        if self.eviction_policy is None:
            from repro_torch.serving.policy import EVICTION, resolve
            self.eviction_policy = resolve(EVICTION)
        return self.eviction_policy

    def _pop_block(self) -> int:
        """Take a block: plain free list first, then evict a cached-free
        block chosen by the registered eviction policy."""
        if self._free:
            blk = self._free.pop()
        elif self._cached_free:
            pol = self._eviction()
            blk = int(pol.select(tuple(self._cached_free), self._stats))
            if blk not in self._cached_free:
                raise RuntimeError(
                    f"eviction policy {getattr(pol, 'name', pol)!r} selected "
                    f"block {blk}, not a cached-free candidate")
            del self._cached_free[blk]
            key = self._hash_of.get(blk)
            self._unregister(blk)
            if self.host_pool is not None and key is not None:
                demote = getattr(pol, "demote", None)
                if demote is None or demote(blk, self._stats):
                    entry = self.host_pool.put(
                        key, self._stats.get(blk, BlockStats()))
                    self.pending_tier_ops.append(("demote", entry, blk))
            pol.on_evict(blk, self._stats)
            self.cache_evictions += 1
        else:
            raise OutOfBlocksError("pool exhausted")
        self.blocks_allocated += 1
        self._stats[blk] = BlockStats()
        self._written[blk] = 0
        return blk

    def _unregister(self, blk: int) -> None:
        key = self._hash_of.pop(blk, None)
        if key is not None and self._block_of.get(key) == blk:
            del self._block_of[key]

    def _decref(self, blk: int) -> None:
        if blk not in self._ref:
            raise RuntimeError(f"double free of block {blk}")
        self._ref[blk] -= 1
        if self._ref[blk] == 0:
            del self._ref[blk]
            if blk in self._hash_of:      # keep content for prefix reuse
                self._cached_free[blk] = None
            else:
                self._free.append(blk)

    # -- lifecycle ----------------------------------------------------------
    def allocate(self, req_id: int, num_tokens: int) -> List[int]:
        if req_id in self._tables:
            raise ValueError(f"request {req_id} already allocated")
        n = max(1, -(-num_tokens // self.block_size))
        if self.num_free < n:
            raise OutOfBlocksError(f"need {n} blocks, have {self.num_free}")
        blocks = [self._pop_block() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self._tables[req_id] = blocks
        self._lens[req_id] = num_tokens
        return blocks

    def allocate_prefix(self, req_id: int, tokens: np.ndarray) -> int:
        """Admit ``req_id`` reusing cached prefix blocks; return #cached tokens.

        Leading full blocks whose chained hash is cached are adopted
        (refcount bump); at least one token is always left to recompute, so
        a fully cached prompt copies its last shared block on first append.
        """
        if req_id in self._tables:
            raise ValueError(f"request {req_id} already allocated")
        bs = self.block_size
        blocks: List[int] = []
        cached = 0
        full = len(tokens) // bs
        for i in range(full):
            key = _prefix_key(tokens, (i + 1) * bs)
            blk = self._block_of.get(key)
            if blk is None and self.host_pool is not None:
                blk = self._promote(key)
            if blk is None:
                break
            self._adopt(blk)
            blocks.append(blk)
            cached += bs
            self.prefix_hits += 1
        self.prefix_misses += full - len(blocks)
        if not blocks:                      # cold start: behave like allocate
            blk = self._pop_block()
            self._ref[blk] = 1
            blocks.append(blk)
        self._tables[req_id] = blocks
        cached = min(cached, max(len(tokens) - 1, 0))
        self._lens[req_id] = cached
        return cached

    def _adopt(self, blk: int) -> None:
        if blk in self._cached_free:
            del self._cached_free[blk]
            self._ref[blk] = 1
        else:
            self._ref[blk] = self._ref.get(blk, 0) + 1
        st = self._stats.setdefault(blk, BlockStats())
        st.hits += 1
        st.peak_ref = max(st.peak_ref, self._ref[blk])

    def _promote(self, key: bytes) -> Optional[int]:
        """Stage a host-tier entry back into a fresh HBM block."""
        entry = self.host_pool.take(key)
        if entry is None:
            return None
        try:
            blk = self._pop_block()
        except OutOfBlocksError:
            self.host_pool.untake(key, entry)
            return None
        self._hash_of[blk] = key
        self._block_of[key] = blk
        self._stats[blk] = entry.stats
        self._written[blk] = self.block_size
        self.pending_tier_ops.append(("promote", entry, blk))
        return blk

    def peek_prefix(self, tokens: np.ndarray) -> int:
        """#tokens a prompt would get from the cache, without mutating it."""
        bs = self.block_size
        cached = 0
        for i in range(len(tokens) // bs):
            if _prefix_key(tokens, (i + 1) * bs) not in self._block_of:
                break
            cached += bs
        return min(cached, max(len(tokens) - 1, 0))

    def extend_prefix(self, req_id: int, tokens: np.ndarray) -> int:
        """Same-wave prefix dedup: fast-forward a mid-prefill request over
        blocks another request published (full and written) since it was
        admitted.  Returns the number of tokens fast-forwarded."""
        bs = self.block_size
        pos = self._lens[req_id]
        table = self._tables[req_id]
        adopted = 0
        while pos % bs == 0 and pos + bs <= len(tokens) - 1:
            blk = self._block_of.get(_prefix_key(tokens, pos + bs))
            if blk is None or self._written.get(blk, 0) < bs:
                break
            bi = pos // bs
            if bi < len(table):
                own = table[bi]
                if (own == blk or self._ref.get(own) != 1
                        or own in self._hash_of
                        or self._written.get(own, 0) > 0):
                    break               # frontier block already has content
                table[bi] = blk
                self._decref(own)       # untouched placeholder -> free list
            else:
                table.append(blk)
            self._adopt(blk)
            self.prefix_hits += 1
            pos += bs
            adopted += bs
        if adopted:
            self._lens[req_id] = pos
        return adopted

    def register_prefix(self, req_id: int, tokens: np.ndarray,
                        num_valid: int, start: int = 0) -> None:
        """Publish content hashes for full blocks covered by committed KV."""
        bs = self.block_size
        table = self._tables[req_id]
        for i in range(start // bs, num_valid // bs):
            blk = table[i]
            if blk in self._hash_of:
                continue
            key = _prefix_key(tokens, (i + 1) * bs)
            if key in self._block_of:       # identical content already cached
                continue
            self._hash_of[blk] = key
            self._block_of[key] = blk

    def reserve_tokens(self, req_id: int, n: int) -> np.ndarray:
        """Reserve write slots for the next ``n`` tokens; returns (n, 2).

        Grows the table on demand and copies shared target blocks on write
        (the pair lands in :attr:`pending_copies`).  Does not advance the
        sequence: call :meth:`commit_tokens` once the KV is written.
        """
        pos0 = self._lens[req_id]
        table = self._tables[req_id]
        out = np.zeros((n, 2), np.int32)
        for j in range(n):
            pos = pos0 + j
            bi = pos // self.block_size
            if bi == len(table):
                blk = self._pop_block()
                self._ref[blk] = 1
                table.append(blk)
            blk = table[bi]
            if self._ref[blk] > 1:          # shared: copy-on-write
                new = self._pop_block()
                self._ref[new] = 1
                self._ref[blk] -= 1
                table[bi] = new
                self.pending_copies.append((blk, new))
                self.cow_copies += 1
                self._written[new] = self._written.get(blk, 0)
                blk = new
            elif blk in self._hash_of:      # private but published: invalidate
                self._unregister(blk)
            out[j] = (blk, pos % self.block_size)
        return out

    def commit_tokens(self, req_id: int, n: int) -> None:
        pos0 = self._lens[req_id]
        if n > 0:                           # advance KV-written watermarks
            bs = self.block_size
            table = self._tables[req_id]
            for bi in range(pos0 // bs, (pos0 + n - 1) // bs + 1):
                filled = min(pos0 + n - bi * bs, bs)
                blk = table[bi]
                if filled > self._written.get(blk, 0):
                    self._written[blk] = filled
        self._lens[req_id] = pos0 + n

    # Single-token conveniences (the reference's legacy API, used by the
    # paper-path decode loop and the benchmarks).
    def reserve_slot(self, req_id: int) -> Tuple[int, int]:
        blk, off = self.reserve_tokens(req_id, 1)[0]
        return int(blk), int(off)

    def commit_token(self, req_id: int) -> None:
        self.commit_tokens(req_id, 1)

    def append_token(self, req_id: int) -> Tuple[int, int]:
        """reserve + commit in one call."""
        slot = self.reserve_slot(req_id)
        self.commit_token(req_id)
        return slot

    def drain_copies(self) -> List[Tuple[int, int]]:
        copies, self.pending_copies = self.pending_copies, []
        return copies

    def drain_tier_ops(self) -> List[Tuple[str, HostBlock, int]]:
        ops, self.pending_tier_ops = self.pending_tier_ops, []
        return ops

    def rewind(self, req_id: int, n: int = 1) -> None:
        """Drop the last ``n`` committed tokens."""
        self.truncate(req_id, max(self._lens[req_id] - n, 0))

    def truncate(self, req_id: int, new_len: int) -> None:
        """Keep only the first ``new_len`` tokens of ``req_id``."""
        if not 0 <= new_len <= self._lens[req_id]:
            raise ValueError(f"truncate to {new_len} outside "
                             f"[0, {self._lens[req_id]}]")
        table = self._tables[req_id]
        keep = max(1, -(-new_len // self.block_size))
        while len(table) > keep:
            self._decref(table.pop())
        self._lens[req_id] = new_len
        last = table[-1]
        off = max(new_len - (len(table) - 1) * self.block_size, 0)
        if (self._ref.get(last) == 1 and last not in self._hash_of
                and off < self._written.get(last, 0)):
            self._written[last] = off

    def free(self, req_id: int) -> None:
        if req_id not in self._tables:
            raise KeyError(f"free of unknown request {req_id} (double free?)")
        for blk in self._tables.pop(req_id):
            self._decref(blk)
        del self._lens[req_id]

    @property
    def num_free(self) -> int:
        """Allocatable blocks: truly free + evictable cached-free."""
        return len(self._free) + len(self._cached_free)

    def check_invariants(self, *, drained: bool = False) -> None:
        """Validate the allocator's internal state; raise ``ValueError``
        naming the first violated invariant.  ``drained=True`` also requires
        the idle state: every block free, no tables, no pending traffic."""
        def fail(msg: str) -> None:
            raise ValueError(msg)

        bs, blocks = self.block_size, set(range(self.num_blocks))
        free, cached = set(self._free), set(self._cached_free)
        live = set(self._ref)
        if len(free) != len(self._free):
            fail(f"duplicate ids on free list: {sorted(self._free)}")
        for a, b, what in ((free, cached, "free and cached-free"),
                           (free, live, "free and refcounted"),
                           (cached, live, "cached-free and refcounted")):
            if a & b:
                fail(f"blocks both {what}: {sorted(a & b)}")
        if (free | cached | live) != blocks:
            fail(f"blocks neither free nor tracked: "
                 f"{sorted(blocks - free - cached - live)}")
        occurrences: Dict[int, int] = {}
        for table in self._tables.values():
            for blk in table:
                occurrences[blk] = occurrences.get(blk, 0) + 1
        if occurrences != self._ref:
            off = {blk: (occurrences.get(blk, 0), self._ref.get(blk, 0))
                   for blk in set(occurrences) | set(self._ref)
                   if occurrences.get(blk, 0) != self._ref.get(blk, 0)}
            fail(f"refcounts disagree with table occurrences "
                 f"(block: (occurrences, refcount)): {off}")
        if set(self._lens) != set(self._tables):
            fail(f"_lens keys {sorted(self._lens)} != _tables keys "
                 f"{sorted(self._tables)}")
        for rid, table in self._tables.items():
            if not table:
                fail(f"request {rid} has an empty block table")
            if len(table) < -(-self._lens[rid] // bs):
                fail(f"request {rid}: {len(table)} blocks cover only "
                     f"{len(table) * bs} tokens < committed {self._lens[rid]}")
        if {k: b for b, k in self._hash_of.items()} != dict(self._block_of):
            fail("prefix cache maps are not inverse bijections")
        if not cached <= set(self._hash_of):
            fail(f"cached-free blocks without a content hash: "
                 f"{sorted(cached - set(self._hash_of))}")
        for blk, w in self._written.items():
            if not 0 <= w <= bs:
                fail(f"block {blk} watermark {w} outside [0, {bs}]")
        for kind, entry, blk in self.pending_tier_ops:
            if kind == "promote" and entry.data is None:
                fail(f"pending promote of block {blk} has no host data")
        for src, dst in self.pending_copies:
            if not (0 <= src < self.num_blocks
                    and 0 <= dst < self.num_blocks):
                fail(f"pending copy ({src}, {dst}) out of range")
            if dst not in self._ref:
                fail(f"pending copy destination {dst} is not a live block")
        if drained:
            if self.num_free != self.num_blocks:
                fail(f"not drained: {self.num_free}/{self.num_blocks} free")
            if self._tables or self.pending_copies or self.pending_tier_ops:
                fail(f"not drained: tables={sorted(self._tables)} "
                     f"copies={self.pending_copies} "
                     f"tier_ops={len(self.pending_tier_ops)}")

    def ref_count(self, block: int) -> int:
        return self._ref.get(block, 0)

    def written(self, block: int) -> int:
        return self._written.get(block, 0)

    def block_stats(self, block: int) -> BlockStats:
        return self._stats.setdefault(block, BlockStats())

    def seq_len(self, req_id: int) -> int:
        return self._lens[req_id]

    def table(self, req_id: int) -> List[int]:
        return list(self._tables[req_id])

    # -- device layouts ------------------------------------------------------
    def build_block_table(self, req_ids: List[int], max_blocks: int,
                          pad_block: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """vLLM_base's padded layout: (B, max_blocks) table + seq_lens (B,).

        Padding entries point at ``pad_block``; the baseline gathers them
        anyway, which is the redundant-gather cost the paper measures.
        """
        B = len(req_ids)
        tab = np.full((B, max_blocks), pad_block, np.int32)
        lens = np.zeros((B,), np.int32)
        for i, r in enumerate(req_ids):
            t = self._tables[r]
            if len(t) > max_blocks:
                raise ValueError(f"request {r} holds {len(t)} blocks, more "
                                 f"than max_blocks={max_blocks}")
            tab[i, :len(t)] = t
            lens[i] = self._lens[r]
        return tab, lens

    def build_block_list(self, req_ids: List[int],
                         max_total: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
        """vLLM_opt's flat layout: ``(block_list, block_req, block_pos,
        seq_lens)`` — the pool blocks of ONLY effectual entries (T,), each
        one's request index in ``[0, B)`` and its position in the request,
        and seq_lens (B,).  With ``max_total`` the lists are padded to that
        length with request ``B`` (out of range: dropped by the kernels).
        """
        lists: List[int] = []
        reqs: List[int] = []
        poss: List[int] = []
        lens = np.zeros((len(req_ids),), np.int32)
        for i, r in enumerate(req_ids):
            t = self._tables[r]
            lists.extend(t)
            reqs.extend([i] * len(t))
            poss.extend(range(len(t)))
            lens[i] = self._lens[r]
        if max_total is not None:
            pad = max_total - len(lists)
            if pad < 0:
                raise ValueError(f"{len(lists)} entries exceed "
                                 f"max_total={max_total}")
            lists.extend([0] * pad)
            reqs.extend([len(req_ids)] * pad)
            poss.extend([0] * pad)
        return (np.asarray(lists, np.int32), np.asarray(reqs, np.int32),
                np.asarray(poss, np.int32), lens)

    def write_slots(self, req_ids: List[int]) -> np.ndarray:
        """(B, 2) [block, offset] where the NEXT token of each request
        lands; reserves blocks on demand (:meth:`commit_token` after the
        step)."""
        out = np.zeros((len(req_ids), 2), np.int32)
        for i, r in enumerate(req_ids):
            out[i] = self.reserve_tokens(r, 1)[0]
        return out


# ---------------------------------------------------------------------------
# Device-side pool ops (torch; the pool is updated in place)
# ---------------------------------------------------------------------------
def make_pool(num_layers: int, num_blocks: int, block_size: int,
              num_kv: int, head_dim: int, dtype=torch.bfloat16,
              device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Split K and V pools, each ``(L, NB, BS, KV, HD)``, zero-filled (the
    paper path's layout)."""
    shape = (num_layers, num_blocks, block_size, num_kv, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def make_fused_pool(num_layers: int, num_blocks: int, block_size: int,
                    num_kv: int, head_dim: int, dtype=torch.bfloat16,
                    device="cpu") -> torch.Tensor:
    """ONE head-interleaved KV buffer ``(L, NB, BS, 2*KV, HD)``,
    ``[K0, V0, K1, V1, ...]`` on the head axis, zero-filled."""
    return torch.zeros((num_layers, num_blocks, block_size, 2 * num_kv,
                        head_dim), dtype=dtype, device=device)


def fused_kv_views(pool: torch.Tensor):
    """Split views of a fused pool: ``(..., 2*KV, HD) -> k, v`` (no copy)."""
    *lead, kv2, hd = pool.shape
    r = pool.reshape(*lead, kv2 // 2, 2, hd)
    return r[..., 0, :], r[..., 1, :]


def fuse_kv_heads(k_new: torch.Tensor, v_new: torch.Tensor) -> torch.Tensor:
    """Interleave ``(..., KV, HD) x2 -> (..., 2*KV, HD)`` as ``[K0,V0,...]``."""
    *lead, kv, hd = k_new.shape
    return torch.stack([k_new, v_new], dim=-2).reshape(*lead, 2 * kv, hd)


def append_to_pool(pool_layer: torch.Tensor, kv_new: torch.Tensor,
                   slots: torch.Tensor,
                   num_lanes: Optional[int] = None) -> torch.Tensor:
    """Write one token per lane into a single layer's pool, in place.

    pool_layer (NB, BS, R, HD); kv_new (T, R, HD); slots (T, 2) [block,
    offset].  The engine renders its real lanes first and gives padding
    lanes the slot ``(NB, 0)``, which JAX drops (``mode="drop"``) and torch
    must not issue.  A caller that knows the real-lane count passes it as
    ``num_lanes`` and only lanes ``[0, num_lanes)`` are written; otherwise
    out-of-range slots are found with a mask, which waits for the device.
    """
    if num_lanes is not None:
        kv_new, slots = kv_new[:num_lanes], slots[:num_lanes]
    else:
        NB, BS = pool_layer.shape[:2]
        ok = ((slots[:, 0] >= 0) & (slots[:, 0] < NB)
              & (slots[:, 1] >= 0) & (slots[:, 1] < BS))
        kv_new, slots = kv_new[ok], slots[ok]
    s = slots.long()
    pool_layer[s[:, 0], s[:, 1]] = kv_new.to(pool_layer.dtype)
    return pool_layer


def copy_pool_blocks(pool: torch.Tensor, srcs, dsts) -> torch.Tensor:
    """Copy whole blocks across the layer-stacked pool (copy-on-write), in
    place.  pool (L, NB, ...); srcs/dsts (n,) block ids.  Every source is
    read before any destination is written; pairs whose destination lies
    outside the pool (the reference's ``src = dst = NB`` padding) are
    dropped and out-of-range sources read the last block, as JAX's clipped
    gather does."""
    NB = pool.shape[1]
    srcs = torch.as_tensor(srcs, dtype=torch.long)
    dsts = torch.as_tensor(dsts, dtype=torch.long)
    keep = (dsts >= 0) & (dsts < NB)
    srcs = srcs[keep].clamp(0, NB - 1).to(pool.device)
    dsts = dsts[keep].to(pool.device)
    if dsts.numel():
        pool[:, dsts] = pool[:, srcs]       # advanced index reads a copy
    return pool


def gather_prefill_into_pool(pool_layer: torch.Tensor, k_seq: torch.Tensor,
                             block_table, seq_len: int,
                             block_size: int) -> torch.Tensor:
    """Write a prefilled (B, S, KV, HD) K (or V) into its pool blocks, in
    place.  block_table (B, nb) lists each request's blocks in order; the
    first ``S // block_size`` of them receive whole blocks."""
    B, S = k_seq.shape[:2]
    nb = block_table.shape[1]
    if nb * block_size < S:
        raise ValueError(f"{nb} blocks of {block_size} hold fewer than {S} "
                         "tokens")
    k_blocks = k_seq.reshape(B, S // block_size, block_size,
                             *k_seq.shape[2:])
    idx = torch.as_tensor(block_table)[:, :S // block_size].reshape(-1)
    pool_layer[idx.long().to(pool_layer.device)] = k_blocks.reshape(
        (-1,) + tuple(k_blocks.shape[2:])).to(pool_layer.dtype)
    return pool_layer
