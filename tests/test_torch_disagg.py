"""The host KV tier and disaggregated prefill/decode serving of the port
against the JAX package's (a port of the reference's ``tests/test_disagg.py``):
reduced smollm-360m, float32, bridged parameters, ``device="cpu"``.

The allocator's watermark, ``transferable``, ``extend_prefix`` and tier
cases run the same operations on both allocators and must give the same
integers; the engines' greedy streams, counters and ``metrics()`` keys
must equal the JAX engines'."""
import jax
import numpy as np
import pytest

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.core import paged_kv as jpk
from repro.models.api import build_model as jax_build_model
from repro.serving import engine as jengine
from repro.serving import policy as jpolicy
from repro.serving.disagg import DisaggEngine as JaxDisaggEngine
from repro_torch.config import ServeConfig, get_config
from repro_torch.core import paged_kv as tpk
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine
from repro_torch.serving import policy as tpolicy
from repro_torch.serving.disagg import DisaggEngine, parse_roles

PORT, REF = (tpk, tpolicy), (jpk, jpolicy)


# --------------------------------------------------- allocator, both sides
def _watermark_per_block(pk, pol):
    al = pk.BlockAllocator(num_blocks=8, block_size=4)
    al.allocate(0, 0)
    al.reserve_tokens(0, 6)
    al.commit_tokens(0, 6)
    t = al.table(0)
    assert al.written(t[0]) == 4 and al.written(t[1]) == 2
    return [al.written(t[0]), al.written(t[1]), al.transferable(0)] + t


def _truncate_lowers_private_watermark(pk, pol):
    al = pk.BlockAllocator(num_blocks=8, block_size=4)
    al.allocate(0, 0)
    al.reserve_tokens(0, 3)
    al.commit_tokens(0, 3)
    blk = al.table(0)[0]
    before = al.written(blk)
    al.rewind(0, 2)                         # a spec-style rollback
    assert al.written(blk) == 1
    return [before, al.written(blk), al.transferable(0)]


def _truncate_keeps_published_watermark(pk, pol):
    al = pk.BlockAllocator(num_blocks=8, block_size=4)
    toks = np.arange(4, dtype=np.int32)
    al.allocate_prefix(0, toks)
    al.reserve_tokens(0, 4)
    al.commit_tokens(0, 4)
    al.register_prefix(0, toks, 4)
    blk = al.table(0)[0]
    al.truncate(0, 2)
    assert al.written(blk) == 4
    return [al.written(blk), al.seq_len(0), al.transferable(0)]


def _cow_copy_inherits_watermark(pk, pol):
    al = pk.BlockAllocator(num_blocks=8, block_size=4)
    toks = np.arange(4, dtype=np.int32)
    al.allocate_prefix(0, toks)
    al.reserve_tokens(0, 4)
    al.commit_tokens(0, 4)
    al.register_prefix(0, toks, 4)
    cached = al.allocate_prefix(1, toks)
    al.reserve_tokens(1, 1)                 # shared last block -> CoW
    new = al.table(1)[0]
    assert cached == 3 and new != al.table(0)[0] and al.written(new) == 4
    return [cached, new, al.written(new), al.transferable(1),
            *al.drain_copies()[0]]


def _extend_prefix_adopts(pk, pol):
    al = pk.BlockAllocator(num_blocks=16, block_size=4)
    toks = np.arange(10, dtype=np.int32)
    out = [al.allocate_prefix(0, toks), al.allocate_prefix(1, toks)]
    al.reserve_tokens(0, 8)
    al.commit_tokens(0, 8)
    al.register_prefix(0, toks, 8)
    out += [al.extend_prefix(1, toks), al.seq_len(1),
            al.ref_count(al.table(0)[0])] + al.table(1)
    assert out[2] == 8 and al.table(1)[:2] == al.table(0)[:2]
    al.free(0)
    al.free(1)
    assert al.num_free == al.num_blocks
    return out


def _extend_prefix_requires_full_watermark(pk, pol):
    al = pk.BlockAllocator(num_blocks=16, block_size=4)
    toks = np.arange(10, dtype=np.int32)
    al.allocate_prefix(0, toks)
    al.allocate_prefix(1, toks)
    al.reserve_tokens(0, 2)
    al.commit_tokens(0, 2)                  # half a block written
    donor = al.table(0)[0]
    al._hash_of[donor] = b"x" * 16          # an early publish, simulated
    al._block_of[b"x" * 16] = donor
    got = al.extend_prefix(1, toks)
    assert got == 0
    return [got, al.transferable(0), al.transferable(1)]


def _extend_prefix_swaps_placeholder(pk, pol):
    al = pk.BlockAllocator(num_blocks=16, block_size=4)
    toks = np.arange(10, dtype=np.int32)
    al.allocate_prefix(0, toks)
    al.allocate_prefix(1, toks)             # placeholder popped
    placeholder = al.table(1)[0]
    free_before = al.num_free
    al.reserve_tokens(0, 8)
    al.commit_tokens(0, 8)
    al.register_prefix(0, toks, 8)
    got = al.extend_prefix(1, toks)
    assert got == 8 and placeholder not in al.table(1)
    assert al.num_free == free_before       # a swap, not a leak
    out = [got, placeholder, al.num_free] + al.table(1)
    al.free(0)
    al.free(1)
    return out + [al.num_free]


def _extend_prefix_keeps_touched_frontier(pk, pol):
    al = pk.BlockAllocator(num_blocks=16, block_size=4)
    toks = np.arange(10, dtype=np.int32)
    al.allocate_prefix(0, toks)
    al.allocate_prefix(1, toks)
    al.reserve_tokens(1, 2)                 # the borrower already wrote
    al.commit_tokens(1, 2)
    al.truncate(1, 0)
    al.reserve_tokens(1, 1)
    al.commit_tokens(1, 1)
    al.truncate(1, 0)
    own = al.table(1)[0]
    al._written[own] = 1                    # a sticky partial write
    al.reserve_tokens(0, 8)
    al.commit_tokens(0, 8)
    al.register_prefix(0, toks, 8)
    got = al.extend_prefix(1, toks)
    assert got == 0
    return [got, own, al.written(own)]


def _extend_prefix_leaves_last_token(pk, pol):
    al = pk.BlockAllocator(num_blocks=16, block_size=4)
    toks = np.arange(8, dtype=np.int32)     # exactly 2 blocks
    al.allocate_prefix(0, toks)
    al.allocate_prefix(1, toks)
    al.reserve_tokens(0, 8)
    al.commit_tokens(0, 8)
    al.register_prefix(0, toks, 8)
    got = al.extend_prefix(1, toks)
    assert got == 4 and al.seq_len(1) == 4
    return [got, al.seq_len(1)] + al.table(1)


def _tiered_alloc(pk, pol, num_blocks=2, host=4):
    return pk.BlockAllocator(
        num_blocks=num_blocks, block_size=4,
        eviction_policy=pol.resolve("eviction", "tiered"),
        host_pool=pk.HostPool(host))


def _cache_prefix(al, toks, rid):
    al.allocate_prefix(rid, toks)
    al.reserve_tokens(rid, len(toks))
    al.commit_tokens(rid, len(toks))
    al.register_prefix(rid, toks, len(toks))
    blk = al.table(rid)[0]
    al.free(rid)
    return blk


def _tiered_demote_gate(pk, pol):
    al = _tiered_alloc(pk, pol)
    hot = np.arange(4, dtype=np.int32)
    cold = np.arange(100, 104, dtype=np.int32)
    out = [_cache_prefix(al, hot, 0), _cache_prefix(al, cold, 1),
           al.allocate_prefix(2, np.concatenate([hot, hot[:1]]))]
    al.free(2)
    out += al.allocate(3, 8)                # evicts both cached prefixes
    counters = al.eviction_policy.counters
    assert counters["dropped"] == 1 and counters["demoted"] == 1
    ops = al.drain_tier_ops()
    assert [op[0] for op in ops] == ["demote"]
    return out + [counters["dropped"], counters["demoted"], len(al.host_pool),
                  [(k, b) for k, _, b in ops]]


def _demote_promote_round_trip(pk, pol):
    al = _tiered_alloc(pk, pol)
    hot = np.arange(4, dtype=np.int32)
    twin = np.concatenate([hot, hot[:1]])
    out = [_cache_prefix(al, hot, 0), al.allocate_prefix(1, twin)]
    al.free(1)
    out += al.allocate(2, 8)                # hot demoted to the host
    al.free(2)
    out += [len(al.host_pool), al.peek_prefix(twin),
            al.allocate_prefix(3, twin)]
    new = al.table(3)[0]
    ops = al.drain_tier_ops()
    assert [op[0] for op in ops] == ["demote", "promote"]
    assert ops[0][1] is ops[1][1]           # the same host entry
    assert out[-1] == 4 and al.written(new) == al.block_size
    out += [new, al.ref_count(new), al.written(new),
            al.block_stats(new).hits, al.block_stats(new).peak_ref,
            [(k, b) for k, _, b in ops], dict(al.host_pool.counters)]
    al.free(3)
    return out + [al.num_free]


def _promote_rolls_back(pk, pol):
    al = _tiered_alloc(pk, pol, num_blocks=2)
    hot = np.arange(4, dtype=np.int32)
    _cache_prefix(al, hot, 0)
    al.allocate_prefix(1, np.concatenate([hot, hot[:1]]))
    al.free(1)
    al.allocate(2, 8)                       # hot demoted, pool fully live
    with pytest.raises(pk.OutOfBlocksError):
        al.allocate_prefix(3, np.concatenate([hot, hot[:1]]))
    return [len(al.host_pool), dict(al.host_pool.counters)]


def _host_pool_lru(pk, pol):
    hp = pk.HostPool(2)
    a, b, c = (bytes([i]) * 16 for i in range(3))
    for k in (a, b, c):
        hp.put(k, pk.BlockStats())
    assert hp.take(a) is None
    return [len(hp), a in hp, b in hp, c in hp, dict(hp.counters)]


ALLOCATOR_CASES = [
    _watermark_per_block, _truncate_lowers_private_watermark,
    _truncate_keeps_published_watermark, _cow_copy_inherits_watermark,
    _extend_prefix_adopts, _extend_prefix_requires_full_watermark,
    _extend_prefix_swaps_placeholder, _extend_prefix_keeps_touched_frontier,
    _extend_prefix_leaves_last_token, _tiered_demote_gate,
    _demote_promote_round_trip, _promote_rolls_back, _host_pool_lru]


@pytest.mark.parametrize("case", ALLOCATOR_CASES,
                         ids=[c.__name__[1:] for c in ALLOCATOR_CASES])
def test_allocator_matches_jax(case):
    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return v.item() if hasattr(v, "item") else v

    assert norm(case(*PORT)) == norm(case(*REF))


# ------------------------------------------------------------ the engines
@pytest.fixture(scope="module")
def ref():
    """Both models (the port's with the JAX params bridged), and the
    monolithic streams of both engines on the shared requests."""
    cfg_j = jax_get_config("smollm-360m").reduced(dtype="float32")
    model_j = jax_build_model(cfg_j, remat=False)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-360m").reduced(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, params_j),
                               device="cpu")

    def requests(mod, n=4, lo=12, hi=25, max_new=5):
        r = np.random.default_rng(3)
        shared = r.integers(0, cfg.vocab_size, (8,), dtype=np.int32)
        out = []
        for i in range(n):
            tail = r.integers(0, cfg.vocab_size,
                              (int(r.integers(lo, hi)),), dtype=np.int32)
            prompt = np.concatenate([shared, tail]) if i % 2 else tail
            out.append(mod.Request(req_id=i, prompt=prompt,
                                   max_new_tokens=max_new))
        return out

    outs = {}
    for mod, eng in (
            (jengine, jengine.ServingEngine(
                model_j, params_j, cfg_j,
                JaxServeConfig(model=cfg.name, kv_block_size=8, max_batch=2),
                num_blocks=64)),
            (tengine, tengine.ServingEngine(
                model, params, cfg,
                ServeConfig(model=cfg.name, kv_block_size=8, max_batch=2),
                num_blocks=64, device="cpu"))):
        for q in requests(mod):
            eng.submit(q)
        eng.run_until_done()
        outs[mod] = {q.req_id: list(q.output) for q in eng.finished}
    assert outs[tengine] == outs[jengine] and len(outs[jengine]) == 4
    return {"jax": (cfg_j, model_j, params_j), "port": (cfg, model, params),
            "requests": requests, "outputs": outs[tengine]}


def _run_disagg(ref, serve_kw, engine_kw=None, requests_kw=None,
                side="port"):
    cfg, model, params = ref[side]
    kw = dict(model=cfg.name, kv_block_size=8, max_batch=2,
              roles="prefill,decode", **serve_kw)
    if side == "port":
        eng = DisaggEngine(model, params, cfg, ServeConfig(**kw),
                           num_blocks=64, device="cpu", **(engine_kw or {}))
        mod = tengine
    else:
        eng = JaxDisaggEngine(model, params, cfg, JaxServeConfig(**kw),
                              num_blocks=64, **(engine_kw or {}))
        mod = jengine
    for q in ref["requests"](mod, **(requests_kw or {})):
        eng.submit(q)
    eng.run_until_done()
    return {q.req_id: list(q.output) for q in eng.finished}, eng


def test_engine_same_wave_dedup_matches_jax(ref):
    prompt = np.random.default_rng(0).integers(
        0, ref["port"][0].vocab_size, (20,), dtype=np.int32)
    got = {}
    for side, mod, extra in (("port", tengine, {"device": "cpu"}),
                             ("jax", jengine, {})):
        cfg, model, params = ref[side]
        sc = (ServeConfig if side == "port" else JaxServeConfig)(
            model=cfg.name, kv_block_size=4, max_batch=2, prefill_chunk=8)
        eng = mod.ServingEngine(model, params, cfg, sc, num_blocks=32,
                                **extra)
        eng.submit(mod.Request(req_id=0, prompt=prompt, max_new_tokens=4))
        eng.submit(mod.Request(req_id=1, prompt=prompt, max_new_tokens=4))
        eng.run_until_done()
        m = eng.metrics()
        got[side] = ({r.req_id: list(r.output) for r in eng.finished},
                     m["prefix_hits"], m["blocks_free"], m["cow_copies"])
    assert got["port"] == got["jax"]
    outs, hits, free, _ = got["port"]
    assert outs[0] == outs[1] and hits > 0 and free == 32


def _tier_rounds(ref, side, num_blocks, host_blocks):
    cfg, model, params = ref[side]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (17,), dtype=np.int32)
    filler = rng.integers(0, cfg.vocab_size, (17,), dtype=np.int32)
    kw = dict(model=cfg.name, kv_block_size=4, max_batch=1,
              eviction="tiered", host_blocks=host_blocks)
    if side == "port":
        eng = tengine.ServingEngine(model, params, cfg, ServeConfig(**kw),
                                    num_blocks=num_blocks, device="cpu")
        mod = tengine
    else:
        eng = jengine.ServingEngine(model, params, cfg, JaxServeConfig(**kw),
                                    num_blocks=num_blocks)
        mod = jengine
    outs = []
    for i, p in enumerate([prompt, prompt, filler, prompt]):
        eng.submit(mod.Request(req_id=i, prompt=p, max_new_tokens=4))
        eng.run_until_done()
        outs.append(list(eng.finished[-1].output))
    return outs, eng


def test_engine_tier_round_trip_matches_jax(ref):
    """A prefix demoted to the host and promoted back gives the roomy
    run's greedy streams: the KV survives the round trip."""
    roomy, _ = _tier_rounds(ref, "port", 64, 8)
    outs, eng = _tier_rounds(ref, "port", 7, 8)
    outs_j, eng_j = _tier_rounds(ref, "jax", 7, 8)
    assert outs == roomy == outs_j
    hp = eng.host_pool
    assert hp.counters["demotes"] > 0 and hp.counters["promotes"] > 0
    assert hp.counters == eng_j.host_pool.counters
    m, mj = eng.metrics(), eng_j.metrics()
    assert m["tier"] == mj["tier"] and m["tier"]["host_blocks"] == 8
    assert m["role"] == mj["role"] == "full"
    assert {k: v for k, v in m["policy_counters"].items()
            if k.startswith("tier.")} == {
        k: v for k, v in mj["policy_counters"].items()
        if k.startswith("tier.")}
    assert m["blocks_free"] == 7            # no leak under tier traffic
    eng.alloc.check_invariants(drained=True)


def test_disagg_matches_monolithic_and_jax(ref):
    outs, eng = _run_disagg(ref, {"eviction": "tiered", "host_blocks": 8})
    outs_j, eng_j = _run_disagg(ref, {"eviction": "tiered",
                                      "host_blocks": 8}, side="jax")
    assert outs == ref["outputs"] == outs_j
    assert eng.num_handoffs == eng_j.num_handoffs > 0
    for e in (eng.pre, eng.dec):
        e.alloc.check_invariants(drained=True)
    assert not eng._staged and not eng._pending_handoffs
    m, mj = eng.metrics(), eng_j.metrics()
    assert m["role"] == mj["role"] == "prefill,decode"
    assert set(m["roles"]) == set(mj["roles"]) == {"prefill", "decode"}
    for role in ("prefill", "decode"):
        assert set(m["roles"][role]) == set(mj["roles"][role])
        for k, v in mj["roles"][role].items():
            if k not in ("backend", "phase_s"):
                assert m["roles"][role][k] == v, (role, k)
    assert m["handoffs"] == mj["handoffs"]
    assert set(m["handoff_ms"]) == set(mj["handoff_ms"])
    assert m["handoff_ms"]["n"] == m["handoffs"]
    assert m["roles"]["prefill"]["prefills_completed"] == m["handoffs"]
    tier = {k: v for k, v in mj["policy_counters"].items()
            if k.startswith("tier.")}
    assert "tier.prefill.demotes" in tier
    assert {k: v for k, v in m["policy_counters"].items()
            if k.startswith("tier.")} == tier
    assert m["tier"] == mj["tier"] and m["tier"]["hbm_blocks"] == 64


@pytest.mark.parametrize("ratio", [1, 7])
def test_disagg_interleave_ratio_does_not_change_outputs(ref, ratio):
    outs, _ = _run_disagg(ref, {},
                          engine_kw={"decode_steps_per_step": ratio})
    assert outs == ref["outputs"]


def test_disagg_routes_sub_block_prompts_direct(ref):
    outs, eng = _run_disagg(ref, {}, requests_kw={"lo": 3, "hi": 6, "n": 2})
    outs_j, eng_j = _run_disagg(ref, {}, side="jax",
                                requests_kw={"lo": 3, "hi": 6, "n": 2})
    assert eng.num_direct == eng_j.num_direct > 0
    assert outs == outs_j and len(outs) == 2


def test_disagg_submit_validation(ref):
    for side, mod in (("port", tengine), ("jax", jengine)):
        cfg, model, params = ref[side]
        kw = dict(model=cfg.name, kv_block_size=8, max_batch=2,
                  roles="prefill,decode")
        eng = (DisaggEngine(model, params, cfg, ServeConfig(**kw),
                            num_blocks=64, device="cpu") if side == "port"
               else JaxDisaggEngine(model, params, cfg, JaxServeConfig(**kw),
                                    num_blocks=64))
        with pytest.raises(ValueError):
            eng.submit(mod.Request(req_id=-1,
                                   prompt=np.arange(4, dtype=np.int32),
                                   max_new_tokens=1))
        eng.submit(mod.Request(req_id=0, prompt=np.arange(4, dtype=np.int32),
                               max_new_tokens=1))
        with pytest.raises(ValueError):         # duplicate id
            eng.submit(mod.Request(req_id=0,
                                   prompt=np.arange(4, dtype=np.int32),
                                   max_new_tokens=1))
        big = np.zeros((8 * 70,), np.int32)     # stages more than the pool
        with pytest.raises(ValueError):
            eng.submit(mod.Request(req_id=1, prompt=big, max_new_tokens=1))
    with pytest.raises(ValueError):
        parse_roles("prefill,prefill")
    assert parse_roles("split") == ("prefill", "decode")
    assert parse_roles("") == ()


def test_prefill_role_parks_and_hands_over(ref):
    """The prefill role samples nothing: a request whose last chunk
    commits is parked with its blocks live and transferable, leaves the
    scheduler on take_prefilled(), and frees its blocks to the cache."""
    cfg, model, params = ref["port"]
    eng = tengine.ServingEngine(
        model, params, cfg,
        ServeConfig(model=cfg.name, kv_block_size=8, max_batch=2),
        num_blocks=16, role="prefill", device="cpu")
    q = ref["requests"](tengine, n=1)[0]
    eng.submit(q)
    while not eng.prefilled:
        eng.step()
    assert q.output == [] and q.state is tengine.RequestState.PREFILLING
    assert eng.alloc.transferable(q.req_id)
    assert eng.take_prefilled() == [q] and not eng.busy and q.slot == -1
    eng.alloc.free(q.req_id)
    eng.alloc.check_invariants(drained=True)
    assert eng.metrics()["role"] == "prefill"


@pytest.mark.parametrize(
    "eviction,spec,overlap",
    [(e, s, o) for e in ("lru", "tiered") for s in ("off", "ngram")
     for o in (False, True)],
    ids=lambda v: str(v).lower())
def test_disagg_parity_sweep(ref, eviction, spec, overlap):
    """Greedy streams equal the monolithic engine's (and JAX's) across
    eviction x spec x overlap; the host tier rides along with tiered."""
    kw = {"eviction": eviction, "spec": spec, "overlap": overlap}
    if eviction == "tiered":
        kw["host_blocks"] = 8
    outs, eng = _run_disagg(ref, kw)
    assert outs == ref["outputs"], f"{kw} diverged"
    eng.dec.alloc.check_invariants(drained=True)
    eng.pre.alloc.check_invariants(drained=True)
