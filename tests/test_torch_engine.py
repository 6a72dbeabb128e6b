"""The port's serving engine against the JAX package's on the same submits:
reduced smollm-360m, float32, bridged parameters, ``device="cpu"``.

Greedy token streams must be identical, and so must the preemption,
prefix-hit and copy-on-write counters; the rendered host arrays of a mixed
step must match exactly.  Stochastic sampling is held to the reference's
filtered support (``jax.random`` cannot be replayed in torch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.serving import engine as jengine
from repro.serving import policy as jpolicy
from repro.serving import sampling as jsampling
from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine
from repro_torch.serving import policy as tpolicy
from repro_torch.serving import sampling as tsampling

BS = 4


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_get_config("smollm-360m").reduced(dtype="float32")
    model_j = jax_build_model(cfg_j, remat=False)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config("smollm-360m").reduced(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    return (cfg_j, model_j, params_j), (cfg_t, model_t, params_t)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, (12,), dtype=np.int32)
    return [
        shared,                                         # prefix donor
        rng.integers(0, vocab, (9,), dtype=np.int32),
        rng.integers(0, vocab, (14,), dtype=np.int32),
        shared.copy(),                                  # full hit -> CoW
        np.concatenate([shared[:8],
                        rng.integers(0, vocab, (5,), dtype=np.int32)]),
    ]


def _engines(models, num_blocks, *, late=(), **kw):
    """Both engines with the same requests submitted; requests whose index
    is in ``late`` are left for :func:`_submit`."""
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    ej = jengine.ServingEngine(
        model_j, params_j, cfg_j,
        JaxServeConfig(model=cfg_j.name, kv_block_size=BS, max_batch=4,
                       prefill_chunk=8),
        num_blocks=num_blocks, **kw)
    et = tengine.ServingEngine(
        model_t, params_t, cfg_t,
        ServeConfig(model=cfg_t.name, kv_block_size=BS, max_batch=4,
                    prefill_chunk=8),
        num_blocks=num_blocks, device="cpu", **kw)
    _submit(ej, et, [i for i in range(5) if i not in late])
    return ej, et


def _submit(ej, et, ids):
    prompts = _prompts(et.cfg.vocab_size)
    for i in ids:
        ej.submit(jengine.Request(req_id=i, prompt=prompts[i],
                                  max_new_tokens=6, arrival=float(i)))
        et.submit(tengine.Request(req_id=i, prompt=prompts[i],
                                  max_new_tokens=6, arrival=float(i)))


_COUNTERS = ("steps", "preemptions", "prefix_hits", "prefix_misses",
             "cow_copies", "output_tokens", "slot_compactions")


@pytest.mark.parametrize("num_blocks,policy", [
    (64, {}),                                   # roomy: prefix hits + CoW
    (10, {}),                                   # starved: preemptions
    (10, dict(preemption="most-blocks", eviction="hit-rate")),
])
def test_engine_greedy_streams_and_counters_match_jax(models, num_blocks,
                                                      policy):
    # the prompt twin of request 0 arrives once 0's prefix is published
    # and while 0 still runs: a full prefix hit on live blocks -> CoW
    ej, et = _engines(models, num_blocks, late=(3, 4), **policy)
    for _ in range(2):
        ej.step()
        et.step()
    _submit(ej, et, (3, 4))
    ej.run_until_done()
    et.run_until_done()
    out_j = {r.req_id: list(r.output) for r in ej.finished}
    out_t = {r.req_id: list(r.output) for r in et.finished}
    assert out_t == out_j
    mj, mt = ej.metrics(), et.metrics()
    for key in _COUNTERS:
        assert mt[key] == mj[key], key
    if num_blocks == 64:
        assert mt["prefix_hits"] > 0 and mt["cow_copies"] > 0
    else:
        assert mt["preemptions"] > 0
    et.alloc.check_invariants(drained=True)


def test_render_matches_jax_on_a_mixed_step(models):
    ej, et = _engines(models, 64)
    for _ in range(3):                  # decode lanes beside prefill chunks
        ej.step()
        et.step()
    plan_j, plan_t = ej.scheduler.schedule(), et.scheduler.schedule()
    assert plan_j.decode and plan_j.prefill
    lists_j, tokens_j, tok_src_j, sample_j, spec_j, _ = ej._render(plan_j)
    lists_t, tokens_t, tok_src_t, sample_t, spec_t, _ = et._render(plan_t)
    assert spec_t is None and spec_j is None
    np.testing.assert_array_equal(tok_src_t, np.asarray(tok_src_j))
    assert set(lists_t) == set(lists_j)
    for k in lists_t:
        np.testing.assert_array_equal(lists_t[k], np.asarray(lists_j[k]), k)
    np.testing.assert_array_equal(tokens_t, np.asarray(tokens_j))
    for t, j in zip(sample_t, sample_j):
        np.testing.assert_array_equal(t, np.asarray(j))
    # allocator state after the reservations: tables, refcounts, cache
    for rid in et.active:
        assert et.alloc.table(rid) == ej.alloc.table(rid)
        assert et.alloc.seq_len(rid) == ej.alloc.seq_len(rid)
    assert et.alloc._ref == ej.alloc._ref
    assert list(et.alloc._cached_free) == list(ej.alloc._cached_free)


def test_filter_logits_matches_jax_and_samples_stay_in_support():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 64)).astype(np.float32) * 3
    temps = np.asarray([0.0, 0.7, 1.0, 1.3, 0.9], np.float32)
    top_ks = np.asarray([0, 5, 0, 12, 3], np.int32)
    top_ps = np.asarray([1.0, 1.0, 0.8, 0.5, 0.9], np.float32)
    got = tsampling.filter_logits(torch.from_numpy(logits),
                                  torch.from_numpy(temps),
                                  torch.from_numpy(top_ks),
                                  torch.from_numpy(top_ps)).numpy()
    want = np.stack([np.asarray(jsampling.filter_logits(
        jnp.asarray(logits[i]), temps[i], top_ks[i], top_ps[i]))
        for i in range(5)])
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampling.sample_batched(
            gen, torch.from_numpy(logits), torch.from_numpy(temps),
            torch.from_numpy(top_ks), torch.from_numpy(top_ps)).numpy()
        assert tok[0] == np.argmax(logits[0])          # greedy lane
        assert np.all(np.isfinite(want[np.arange(5), tok]))


@pytest.mark.parametrize("kw", [dict(roles="prefill,decode"),
                                dict(mesh=object()), dict(devices=2),
                                dict(host_blocks=4), dict(role="prefill")])
def test_engine_refuses_what_the_port_leaves_out(models, kw):
    _, (cfg_t, model_t, params_t) = models
    ctor = {k: kw.pop(k) for k in ("mesh", "role") if k in kw}
    with pytest.raises(NotImplementedError):
        tengine.ServingEngine(model_t, params_t, cfg_t,
                              ServeConfig(model=cfg_t.name, **kw),
                              num_blocks=8, device="cpu", **ctor)


def test_engine_refuses_an_unknown_attn_impl(models):
    _, (cfg_t, model_t, params_t) = models
    with pytest.raises(ValueError, match="attn_impl"):
        tengine.ServingEngine(model_t, params_t, cfg_t,
                              ServeConfig(model=cfg_t.name,
                                          attn_impl="flash"),
                              num_blocks=8, device="cpu")


def test_engine_serves_overlap_and_spec(models):
    _, (cfg_t, model_t, params_t) = models
    for kw in (dict(overlap=True), dict(spec="ngram"),
               dict(spec="draft-model")):
        eng = tengine.ServingEngine(model_t, params_t, cfg_t,
                                    ServeConfig(model=cfg_t.name, **kw),
                                    num_blocks=8, device="cpu")
        m = eng.metrics()
        assert m["overlap"] is kw.get("overlap", False)
        assert m["spec"]["proposer"] == kw.get("spec", "off")


_JAX_STEP = {}
PAIRS = [(a, e) for a in tpolicy.names(tpolicy.ADMISSION)
         for e in tpolicy.names(tpolicy.EVICTION)]


@pytest.mark.parametrize("admission,eviction", PAIRS)
def test_policy_sweep_matches_jax(models, admission, eviction):
    """Every registered (admission, preemption, eviction) triple in the
    starved pool, preemption cycled through its four policies: greedy
    streams, counters, finish order and policy counters equal JAX's.  The
    JAX engines share one engine's jitted step (the same program: the
    ServeConfig and model are the same), so each triple compiles once."""
    assert len(PAIRS) == 25
    assert tpolicy.names(tpolicy.ADMISSION) == jpolicy.names(
        jpolicy.ADMISSION)
    assert tpolicy.names(tpolicy.EVICTION) == jpolicy.names(jpolicy.EVICTION)
    assert tpolicy.names(tpolicy.PREEMPTION) == jpolicy.names(
        jpolicy.PREEMPTION)
    for preemption in tpolicy.names(tpolicy.PREEMPTION):
        ej, et = _engines(models, 10, late=(3, 4), admission=admission,
                          preemption=preemption, eviction=eviction)
        first = _JAX_STEP.setdefault("engine", ej)
        ej._step_fn, ej._copy_fn = first._step_fn, first._copy_fn
        for _ in range(2):
            ej.step()
            et.step()
        _submit(ej, et, (3, 4))
        ej.run_until_done()
        et.run_until_done()
        assert [r.req_id for r in et.finished] == [
            r.req_id for r in ej.finished]
        assert {r.req_id: list(r.output) for r in et.finished} == {
            r.req_id: list(r.output) for r in ej.finished}
        mj, mt = ej.metrics(), et.metrics()
        for key in _COUNTERS:
            assert mt[key] == mj[key], (preemption, key)
        assert mt["policy_counters"] == {
            k: v for k, v in mj["policy_counters"].items()
            if k.split(".")[0] in tpolicy.AXES}, preemption
        et.alloc.check_invariants(drained=True)
