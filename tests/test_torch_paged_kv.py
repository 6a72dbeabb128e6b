"""The port's block allocator and device pool ops against the JAX
package's: the same operation sequence gives identical tables, refcounts,
cached-free sets and counters; the pool ops agree on the same arrays."""
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


@pytest.mark.parametrize("eviction", ["lru", "hit-rate", "refcount-aware"])
def test_allocator_sequence_matches_jax(eviction):
    ja = jkv.BlockAllocator(num_blocks=12, block_size=4,
                            eviction_policy=jpolicy.resolve("eviction",
                                                            eviction))
    ta = tkv.BlockAllocator(num_blocks=12, block_size=4,
                            eviction_policy=tpolicy.resolve("eviction",
                                                            eviction))
    for _ in zip(_script(ja), _script(ta)):
        assert _state(ta) == _state(ja)
        ta.check_invariants()
    assert ta.cow_copies == 1 and ta.prefix_hits == 3
    assert ta.cache_evictions > 0
    ta.check_invariants(drained=True)


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
    ja = jkv.BlockAllocator(num_blocks=8, block_size=4,
                            eviction_policy=jpolicy.resolve("eviction",
                                                            "lru"))
    ja.host_pool = jkv.HostPool(4)
    ta = tkv.BlockAllocator(num_blocks=8, block_size=4,
                            eviction_policy=tpolicy.resolve("eviction",
                                                            "lru"),
                            host_pool=tkv.HostPool(4))
    for _ in zip(_tier_script(ja), _tier_script(ta)):
        assert _state(ta) == _state(ja)
        assert ta.host_pool.counters == ja.host_pool.counters
        assert len(ta.host_pool) == len(ja.host_pool)
        ta.check_invariants()
    assert ta.host_pool.counters["promotes"] == 3
    assert ta.eviction_policy.counters == ja.eviction_policy.counters
