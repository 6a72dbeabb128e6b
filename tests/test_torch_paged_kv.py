"""The port's block allocator and device pool ops against the JAX
package's: the same operation sequence gives identical tables, refcounts,
cached-free sets and counters, for every registered eviction policy, with
the pool sharded and with the host tier on; the pool ops agree on the same
arrays."""
import collections.abc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged_kv as jkv
from repro.serving import policy as jpolicy
from repro_torch.core import paged_kv as tkv
from repro_torch.serving import policy as tpolicy


def _state(alloc):
    return (dict(alloc._tables), dict(alloc._lens), dict(alloc._ref),
            list(alloc._cached_free), sorted(alloc._free),
            dict(alloc._written), list(alloc.pending_copies),
            alloc.prefix_hits, alloc.prefix_misses, alloc.cow_copies,
            alloc.cache_evictions, alloc.num_free)


def _script(alloc, rng_seed=0):
    """allocate / reserve / commit / truncate / free, prefix sharing, CoW
    and cache eviction; yields after every operation."""
    rng = np.random.default_rng(rng_seed)
    bs = alloc.block_size
    shared = rng.integers(0, 100, (3 * bs,), dtype=np.int32)
    other = rng.integers(0, 100, (2 * bs + 1,), dtype=np.int32)
    alloc.allocate_prefix(0, shared)
    yield
    alloc.reserve_tokens(0, 3 * bs)
    alloc.commit_tokens(0, 3 * bs)
    alloc.register_prefix(0, shared, 3 * bs)
    yield
    alloc.allocate_prefix(1, shared)                 # full hit, shared blocks
    yield
    alloc.reserve_tokens(1, 2)                       # CoW of the last block
    alloc.commit_tokens(1, 2)
    yield
    assert alloc.drain_copies() == [(alloc.table(0)[2], alloc.table(1)[2])]
    alloc.allocate(2, len(other))
    alloc.reserve_tokens(2, 3)
    alloc.commit_tokens(2, 2)
    alloc.truncate(2, 5)
    yield
    alloc.rewind(1, 2)
    yield
    alloc.free(0)
    alloc.free(1)                                    # blocks park cached-free
    yield
    alloc.allocate(3, alloc.num_free * bs)           # evicts cached blocks
    yield
    alloc.free(3)
    alloc.free(2)
    yield


EVICTIONS = tpolicy.names(tpolicy.EVICTION)


def _pair(eviction, **kw):
    """The JAX allocator and the port's, built alike under ``eviction``."""
    ja = jkv.BlockAllocator(eviction_policy=jpolicy.resolve("eviction",
                                                            eviction), **kw)
    ta = tkv.BlockAllocator(eviction_policy=tpolicy.resolve("eviction",
                                                            eviction), **kw)
    return ja, ta


@pytest.mark.parametrize("eviction", EVICTIONS)
def test_allocator_sequence_matches_jax(eviction):
    ja, ta = _pair(eviction, num_blocks=12, block_size=4)
    for _ in zip(_script(ja), _script(ta)):
        assert _state(ta) == _state(ja)
        ta.check_invariants()
    assert ta.cow_copies == 1 and ta.prefix_hits == 3
    assert ta.cache_evictions > 0
    ta.check_invariants(drained=True)


@pytest.mark.parametrize("eviction", EVICTIONS)
def test_sharded_allocator_sequence_matches_jax(eviction):
    ja, ta = _pair(eviction, num_blocks=12, block_size=4, num_shards=2)
    for _ in zip(_script(ja), _script(ta)):
        assert _state(ta) == _state(ja)
        ta.check_invariants()
    assert ta.cache_evictions > 0
    ta.check_invariants(drained=True)


def _scale_script(alloc, evictions, rng_seed=1):
    """Every block of the pool published as a one-block prompt, a third of
    them borrowed once or twice (hits, a peak refcount above 1), all freed
    in a shuffled order: the whole pool cached-free in an order no sort
    gives.  Then ``evictions`` one-block allocations evict block by block;
    yields each evicting request's block."""
    rng = np.random.default_rng(rng_seed)
    bs, n = alloc.block_size, alloc.num_blocks
    prompts = rng.permutation(n * bs).astype(np.int32).reshape(n, bs)
    for r in range(n):
        alloc.allocate(r, bs)
        alloc.register_prefix(r, prompts[r], bs)
    req = n
    for doc in rng.choice(n, n // 3, replace=False):
        for _ in range(int(rng.integers(1, 3))):
            alloc.allocate_prefix(req, prompts[doc])     # full hit: shared
            req += 1
    for r in rng.permutation(req):
        alloc.free(int(r))
    assert len(alloc._cached_free) == n and not alloc._free
    for r in range(req, req + evictions):
        alloc.allocate(r, 1)
        yield alloc.table(r)[0]


@pytest.mark.parametrize("eviction", EVICTIONS)
def test_eviction_order_matches_jax_at_scale(eviction):
    # 4,096 blocks cached-free; 512 evictions keep the scanning policies'
    # quadratic cost in seconds, and _state then compares the order of
    # the 3,584 left
    ja, ta = _pair(eviction, num_blocks=4096, block_size=2)
    steps = 0
    for jb, tb in zip(_scale_script(ja, 512), _scale_script(ta, 512)):
        assert tb == jb, steps
        steps += 1
    assert steps == 512 and ta.cache_evictions == ja.cache_evictions == 512
    assert len(ta._cached_free) == 4096 - 512
    assert _state(ta) == _state(ja)
    ta.check_invariants()


class _SpyLru(tpolicy.LruEviction):
    """``lru`` that records what each ``select`` is handed."""

    def __init__(self) -> None:
        super().__init__()
        self.seen = []

    def select(self, candidates, stats):
        self.seen.append((candidates, len(candidates), list(candidates)))
        return super().select(candidates, stats)


def test_eviction_policy_gets_the_live_cached_free_view():
    bs = 4
    spy = _SpyLru()
    ta = tkv.BlockAllocator(num_blocks=3, block_size=bs,
                            eviction_policy=spy)
    for r in range(3):
        prompt = np.arange(r * bs, (r + 1) * bs, dtype=np.int32)
        ta.allocate(r, bs)
        ta.register_prefix(r, prompt, bs)
    blocks = [ta.table(r)[0] for r in range(3)]
    for r in (2, 0, 1):                              # freed oldest first
        ta.free(r)
    ta.allocate(3, bs)
    ta.allocate(4, bs)
    (view, n, ids), (_, n2, ids2) = spy.seen
    assert isinstance(view, collections.abc.KeysView)
    assert not isinstance(view, (tuple, list))
    assert n == 3 and ids == [blocks[2], blocks[0], blocks[1]]
    assert n2 == 2 and ids2 == [blocks[0], blocks[1]]
    assert ta.table(3) == [blocks[2]] and ta.table(4) == [blocks[0]]
    # live: the view the first call got has followed both evictions
    assert list(view) == [blocks[1]] == list(ta._cached_free)
    assert len(view) == len(ta._cached_free)
    ta.check_invariants()


def test_eviction_of_a_non_candidate_raises():
    class _Rogue(tpolicy.LruEviction):
        def select(self, candidates, stats):
            return max(candidates) + 1               # not cached-free

    bs = 4
    ta = tkv.BlockAllocator(num_blocks=2, block_size=bs,
                            eviction_policy=_Rogue())
    ta.allocate(0, bs)
    ta.register_prefix(0, np.arange(bs, dtype=np.int32), bs)
    ta.allocate(1, bs)                               # the pool is full
    ta.free(0)
    with pytest.raises(RuntimeError, match="not a cached-free candidate"):
        ta.allocate(2, bs)


def test_check_invariants_names_a_violation():
    ta = tkv.BlockAllocator(num_blocks=4, block_size=4)
    ta.allocate(0, 6)
    ta._ref[ta.table(0)[0]] += 1
    with pytest.raises(ValueError, match="refcounts disagree"):
        ta.check_invariants()


def test_append_to_pool_drops_padding_slots_like_jax():
    rng = np.random.default_rng(0)
    NB, BS, R, HD = 5, 4, 6, 8
    pool = rng.standard_normal((NB, BS, R, HD)).astype(np.float32)
    kv = rng.standard_normal((6, R, HD)).astype(np.float32)
    slots = np.asarray([[1, 0], [NB, 0], [4, 3], [NB, 0], [0, 2], [2, 1]],
                       np.int32)
    want = np.asarray(jkv.append_to_pool(jnp.asarray(pool), jnp.asarray(kv),
                                         jnp.asarray(slots)))
    got = tkv.append_to_pool(torch.from_numpy(pool.copy()),
                             torch.from_numpy(kv), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), want)


def test_append_to_pool_writes_only_the_real_lanes_it_is_told():
    # the engine's layout: real lanes first, then (NB, 0) padding lanes
    rng = np.random.default_rng(2)
    NB, BS, R, HD = 5, 4, 6, 8
    pool = rng.standard_normal((NB, BS, R, HD)).astype(np.float32)
    kv = rng.standard_normal((6, R, HD)).astype(np.float32)
    slots = np.asarray([[1, 0], [4, 3], [0, 2], [2, 1], [NB, 0], [NB, 0]],
                       np.int32)
    want = np.asarray(jkv.append_to_pool(jnp.asarray(pool), jnp.asarray(kv),
                                         jnp.asarray(slots)))
    got = tkv.append_to_pool(torch.from_numpy(pool.copy()),
                             torch.from_numpy(kv), torch.from_numpy(slots),
                             num_lanes=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fuse_kv_heads_and_views_round_trip():
    rng = np.random.default_rng(1)
    k = rng.standard_normal((3, 6, 4, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 6, 4, 2, 8)).astype(np.float32)
    fused = tkv.fuse_kv_heads(torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(
        fused.numpy(), np.asarray(jkv.fuse_kv_heads(jnp.asarray(k),
                                                    jnp.asarray(v))))
    k2, v2 = tkv.fused_kv_views(fused)
    np.testing.assert_array_equal(k2.numpy(), k)
    np.testing.assert_array_equal(v2.numpy(), v)


def test_copy_pool_blocks_matches_jax():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((2, 6, 4, 4, 8)).astype(np.float32)
    NB = pool.shape[1]
    srcs = np.asarray([1, 4, NB, NB], np.int32)      # reference padding
    dsts = np.asarray([4, 5, NB, NB], np.int32)      # 4 is read, then written
    want = np.asarray(jkv.copy_pool_blocks(jnp.asarray(pool),
                                           jnp.asarray(srcs),
                                           jnp.asarray(dsts)))
    got = tkv.copy_pool_blocks(torch.from_numpy(pool.copy()), srcs, dsts)
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_fused_pool_shape():
    pool = tkv.make_fused_pool(3, 7, 4, 5, 16, torch.float32, "cpu")
    assert pool.shape == (3, 7, 4, 10, 16) and not pool.any()


def _tier_script(alloc):
    """Demote cached blocks to the host tier under pressure, then promote
    them back on a prefix hit; yields after every operation."""
    bs = alloc.block_size
    prompt = np.arange(3 * bs, dtype=np.int32)
    alloc.allocate_prefix(0, prompt)
    alloc.reserve_tokens(0, 3 * bs)
    alloc.commit_tokens(0, 3 * bs)
    alloc.register_prefix(0, prompt, 3 * bs)
    alloc.free(0)                                    # 3 blocks cached-free
    yield
    alloc.allocate(1, alloc.num_free * bs)           # evicts -> demotes
    yield
    ops = alloc.drain_tier_ops()
    assert [k for k, _, _ in ops] == ["demote"] * 3
    for _, entry, _ in ops:
        entry.data = ("host copy",)                  # the engine's drain
    alloc.free(1)
    yield
    assert alloc.allocate_prefix(2, prompt) == 3 * bs - 1   # promotes
    yield
    assert [k for k, _, _ in alloc.drain_tier_ops()] == ["promote"] * 3
    alloc.free(2)
    yield


def test_host_tier_demote_promote_matches_jax():
    ja, ta = _pair("lru", num_blocks=8, block_size=4)
    ja.host_pool = jkv.HostPool(4)
    ta.host_pool = tkv.HostPool(4)
    for _ in zip(_tier_script(ja), _tier_script(ta)):
        assert _state(ta) == _state(ja)
        assert ta.host_pool.counters == ja.host_pool.counters
        assert len(ta.host_pool) == len(ja.host_pool)
        ta.check_invariants()
    assert ta.host_pool.counters["promotes"] == 3
    assert ta.eviction_policy.counters == ja.eviction_policy.counters


def _tier_mix_script(alloc):
    """A borrowed prompt (hits, peak refcount 2) and an unshared one, both
    cached-free, evicted by a whole-pool allocation: a demote gate sees
    blocks of both kinds.  Yields the drained tier ops as (kind, key,
    block) after every operation."""
    bs = alloc.block_size
    hot = np.arange(3 * bs, dtype=np.int32)
    cold = np.arange(100, 100 + 2 * bs, dtype=np.int32)
    for r, prompt in ((0, hot), (1, cold)):
        alloc.allocate(r, len(prompt))
        alloc.register_prefix(r, prompt, len(prompt))
    alloc.allocate_prefix(2, hot)                    # borrows hot's blocks
    for r in (1, 0, 2):
        alloc.free(r)
    yield []
    alloc.allocate(3, alloc.num_free * bs)           # evicts every block
    ops = alloc.drain_tier_ops()
    for _, entry, _ in ops:
        entry.data = ("host copy",)                  # the engine's drain
    yield [(k, e.key, b) for k, e, b in ops]
    alloc.free(3)
    alloc.allocate_prefix(4, hot)                    # promotes what was kept
    alloc.allocate_prefix(5, cold)
    yield [(k, e.key, b) for k, e, b in alloc.drain_tier_ops()]
    alloc.free(4)
    alloc.free(5)
    yield []


@pytest.mark.parametrize("eviction", EVICTIONS)
def test_host_tier_eviction_matches_jax(eviction):
    ja, ta = _pair(eviction, num_blocks=8, block_size=4)
    ja.host_pool = jkv.HostPool(4)
    ta.host_pool = tkv.HostPool(4)
    demotes = 0
    for jops, tops in zip(_tier_mix_script(ja), _tier_mix_script(ta)):
        assert tops == jops
        demotes += sum(k == "demote" for k, _, _ in tops)
        assert _state(ta) == _state(ja)
        assert ta.host_pool.counters == ja.host_pool.counters
        assert list(ta.host_pool._entries) == list(ja.host_pool._entries)
        ta.check_invariants()
    assert demotes > 0
    assert ta.eviction_policy.counters == ja.eviction_policy.counters
