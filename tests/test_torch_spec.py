"""The port's speculative decoding (``repro_torch.serving.spec``) against the
reference's ``repro.serving.spec`` on the same inputs: reduced smollm-360m,
float32, bridged parameters, ``device="cpu"``.

Proposals, greedy verify and the scheduler's draft budgeting are exact;
stochastic verify is held as a distribution (its draws come from a torch
generator, which cannot replay ``jax.random``); the verify-step logits of
``decode_tokens_paged`` are held at atol 1e-4; the spec engine's greedy
streams and spec counters must equal both the JAX spec engine's and the
port's draftless engine's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.core.paged_kv import BlockAllocator as JAllocator
from repro.models.api import build_model as jbuild_model
from repro.models.transformer import TransformerLM as JTransformerLM
from repro.serving import engine as jengine
from repro.serving import spec as jspec
from repro.serving.request import RequestState as JState
from repro.serving.scheduler import Scheduler as JScheduler
from repro_torch.config import ServeConfig, get_config
from repro_torch.core.paged_kv import BlockAllocator
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving import engine as tengine
from repro_torch.serving import spec as tspec
from repro_torch.serving.request import RequestState
from repro_torch.serving.scheduler import Scheduler


def _bridge(params):
    return params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def models():
    cfg_j = jget_config("smollm-360m").reduced(dtype="float32")
    model_j = jbuild_model(cfg_j, remat=False)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config("smollm-360m").reduced(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    return (cfg_j, model_j, params_j), (cfg_t, model_t, _bridge(params_j))


@pytest.fixture(scope="module")
def drafts(models):
    """The reference's default draft (half the layers, PRNGKey(17)) and
    the port's, with the JAX draft's parameters bridged."""
    (cfg_j, _, _), (cfg_t, _, _) = models
    dj = JTransformerLM(dataclasses.replace(cfg_j, num_layers=1),
                        remat=False)
    pj = dj.init(jax.random.PRNGKey(17))
    dt = TransformerLM(dataclasses.replace(cfg_t, num_layers=1),
                       device="cpu")
    return (dj, pj), (dt, _bridge(pj))


def _pair(rng, vocab, n, **kw):
    """The same random request for both packages, with some output."""
    prompt = rng.integers(0, vocab, (int(rng.integers(1, 14)),),
                          dtype=np.int32)
    out = [int(t) for t in rng.integers(0, vocab,
                                        (int(rng.integers(0, 6)),))]
    if rng.random() < 0.5 and len(prompt) > 3:     # a loop to match
        out += [int(t) for t in prompt[:3]]
    reqs = []
    for mod in (jengine, tengine):
        r = mod.Request(req_id=n, prompt=prompt.copy(), max_new_tokens=20,
                        **kw)
        r.output = list(out)
        reqs.append(r)
    return reqs


# ---------------------------------------------------------------- proposers
def test_registry_resolution_matches_the_reference():
    assert tspec.names() == jspec.names()
    for name in ("ngram", "draft", "draft-model"):
        assert tspec.resolve(name).name == jspec.resolve(name).name
    assert tspec.resolve() is None and tspec.resolve(config="off") is None
    with tspec.force_proposer("draft"):
        assert tspec.resolve(config="ngram").name == "draft-model"
        assert tspec.resolve("off") is None
    with tspec.record_resolutions() as log:
        tspec.resolve("ngram")
        tspec.resolve(config="draft")
        tspec.resolve()
    assert log == ["ngram", "draft-model", "off"]
    with pytest.raises(tspec.UnknownProposerError):
        tspec.resolve("nope")


def test_ngram_proposals_match_the_reference():
    rng = np.random.default_rng(0)
    pj, pt = jspec.NgramProposer(), tspec.NgramProposer()
    pairs = [_pair(rng, 6, i) for i in range(40)]   # small vocab: matches
    for rj, rt in pairs:
        for k in range(5):
            np.testing.assert_array_equal(pt.propose(rt, k),
                                          pj.propose(rj, k))
    ks = [int(k) for k in rng.integers(0, 5, len(pairs))]
    bt = pt.propose_batch([(rt, k) for (_, rt), k in zip(pairs, ks)])
    bj = pj.propose_batch([(rj, k) for (rj, _), k in zip(pairs, ks)])
    assert bt.keys() == bj.keys()
    for rid in bt:
        np.testing.assert_array_equal(bt[rid], bj[rid])
    assert sum(len(d) for d in bt.values()) > 0


def test_draft_model_proposals_match_the_reference(models, drafts):
    (cfg_j, _, _), _ = models
    (dj, pj), (dt, pt) = drafts
    prop_j = jspec.DraftModelProposer(model=dj, params=pj, window=16)
    prop_t = tspec.DraftModelProposer(model=dt, params=pt, window=16)
    prop_j.bind(None)
    prop_t.bind(None)
    rng = np.random.default_rng(3)
    pairs = [_pair(rng, cfg_j.vocab_size, i) for i in range(5)]
    ks = [3, 1, 2, 0, 3]
    bj = prop_j.propose_batch([(rj, k) for (rj, _), k in zip(pairs, ks)])
    bt = prop_t.propose_batch([(rt, k) for (_, rt), k in zip(pairs, ks)])
    for rid in bj:
        np.testing.assert_array_equal(bt[rid], bj[rid])
    np.testing.assert_array_equal(prop_t.propose(pairs[0][1], 3),
                                  prop_j.propose(pairs[0][0], 3))
    assert prop_t.counters == prop_j.counters
    assert prop_t.counters["batched_rollouts"] == 1


# ------------------------------------------------------------------- verify
def _verify_both(logits, drafts_, lens, temps, top_ks, top_ps, seed=0):
    out_j, acc_j = jspec.verify_batched(
        jax.random.PRNGKey(seed), jnp.asarray(logits), jnp.asarray(drafts_),
        jnp.asarray(lens), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps))
    gen = torch.Generator().manual_seed(seed)
    out_t, acc_t = tspec.verify_batched(
        gen, *(torch.from_numpy(a) for a in (logits, drafts_, lens, temps,
                                              top_ks, top_ps)))
    return (np.asarray(out_j), np.asarray(acc_j), out_t.numpy(),
            acc_t.numpy())


def _verify_inputs(rng, B=16, R=4, V=32):
    logits = rng.standard_normal((B, R, V)).astype(np.float32)
    arg = logits.argmax(-1)
    for b in range(0, B, 3):            # ties: the first index must win
        j = int(rng.integers(0, R))
        top = logits[b, j].max()
        lo = int(rng.integers(0, arg[b, j] + 1))
        logits[b, j, lo] = top
        logits[b, j, V - 1] = top
    arg = logits.argmax(-1)             # numpy takes the first index too
    drafts_ = rng.integers(0, V, (B, R - 1)).astype(np.int32)
    take = rng.random((B, R - 1)) < 0.6
    drafts_ = np.where(take, arg[:, :-1], drafts_).astype(np.int32)
    lens = rng.integers(0, R, (B,)).astype(np.int32)
    return logits, drafts_, lens


def test_verify_greedy_lanes_equal_the_reference_exactly():
    rng = np.random.default_rng(0)
    for _ in range(4):
        logits, drafts_, lens = _verify_inputs(rng)
        B = len(lens)
        out_j, acc_j, out_t, acc_t = _verify_both(
            logits, drafts_, lens, np.zeros(B, np.float32),
            np.zeros(B, np.int32), np.ones(B, np.float32))
        np.testing.assert_array_equal(acc_t, acc_j)
        np.testing.assert_array_equal(out_t, out_j)
        assert 0 < acc_t.sum() < lens.sum()


def test_verify_mixed_batch_greedy_lanes_match():
    rng = np.random.default_rng(1)
    logits, drafts_, lens = _verify_inputs(rng)
    B = len(lens)
    temps = np.where(np.arange(B) % 2 == 0, 0.0, 0.8).astype(np.float32)
    top_ks = np.where(np.arange(B) % 4 == 1, 5, 0).astype(np.int32)
    top_ps = np.where(np.arange(B) % 4 == 3, 0.9, 1.0).astype(np.float32)
    out_j, acc_j, out_t, acc_t = _verify_both(logits, drafts_, lens, temps,
                                              top_ks, top_ps)
    g = temps <= 0
    np.testing.assert_array_equal(acc_t[g], acc_j[g])
    np.testing.assert_array_equal(out_t[g], out_j[g])
    assert np.all((acc_t >= 0) & (acc_t <= lens))
    assert np.all((out_t >= 0) & (out_t < logits.shape[-1]))


@pytest.mark.parametrize("lg,temp,top_k", [
    ([2.0, -2.0, 0.0, 1.0], 1.0, 0),
    ([0.1, 0.0, -0.1, 0.05], 1.0, 0),
    ([-2.0, 1.5, 1.4, 0.0], 1.0, 0),
    ([1.0, 0.5, -0.5, 0.2], 0.7, 2),
])
def test_verify_stochastic_lanes_emit_the_target_law(lg, temp, top_k):
    """The first emitted token of a one-draft stochastic lane follows the
    filtered target ``p`` whatever the draft: accept ``d`` with ``p(d)``,
    else a draw from ``p`` without ``d``; so ``P(t) = p(t)`` exactly, as the
    reference's distribution test holds it (TV < 0.06 at n = 4000)."""
    from repro_torch.serving.sampling import filter_logits

    n, V = 4000, len(lg)
    row = torch.tensor(lg, dtype=torch.float32)
    target = torch.softmax(filter_logits(
        row, torch.tensor(temp), torch.tensor(top_k),
        torch.tensor(1.0)), -1).numpy()
    for draft in range(V):
        gen = torch.Generator().manual_seed(100 + draft)
        out, acc = tspec.verify_batched(
            gen, row.expand(n, 2, V).contiguous(),
            torch.full((n, 1), draft, dtype=torch.int32),
            torch.ones(n, dtype=torch.int32),
            torch.full((n,), temp), torch.full((n,), top_k,
                                               dtype=torch.int32),
            torch.ones(n))
        first = out[:, 0].numpy()
        emp = np.bincount(first, minlength=V) / n
        tv = 0.5 * np.abs(emp - target).sum()
        assert tv < 0.06, (tv, emp, target, draft)
        # accepted exactly as often as p(draft), and never a filtered token
        assert abs(acc.float().mean().item() - target[draft]) < 0.03
        assert np.all(target[first] > 0)


# ---------------------------------------------------------------- scheduler
def _decoding(mod, alloc, rid, prompt_len, state, slot=0, max_new=8):
    r = mod.Request(req_id=rid, prompt=np.arange(prompt_len, dtype=np.int32),
                    max_new_tokens=max_new)
    alloc.allocate(rid, prompt_len)
    r.begin_prefill(slot, prompt_len,
                    active_prompt=np.asarray(r.prompt, np.int32))
    r.to_state(state.DECODING)
    r.output = [1]
    return r


def _prefilling(mod, alloc, rid, slot):
    r = mod.Request(req_id=rid, prompt=np.arange(10, dtype=np.int32),
                    max_new_tokens=4)
    alloc.allocate(rid, 0)
    r.begin_prefill(slot, 0, active_prompt=np.asarray(r.prompt, np.int32))
    return r


# (num_blocks, token_budget, decode prompt_len, with a prefilling request,
#  drafts): tests/test_spec.py's four scheduler cases
SCHED_CASES = {
    "plans_spec_lanes": (8, 8, 4, False, [7, 8, 9]),
    "budget_split_with_prefill": (16, 4, 4, True, [7, 8, 9]),
    "trim_to_budget": (16, 2, 4, False, [7, 8, 9]),
    "shed_before_preempt": (1, 8, 3, False, [7, 8]),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_spec_plans_match_the_reference(case):
    nb, budget, plen, prefill, draft = SCHED_CASES[case]
    plans = []
    for mod, alloc_cls, sched_cls, state in (
            (tengine, BlockAllocator, Scheduler, RequestState),
            (jengine, JAllocator, JScheduler, JState)):
        alloc = alloc_cls(num_blocks=nb, block_size=4)
        sched = sched_cls(alloc, max_batch=2, token_budget=budget)
        sched.running = {0: _decoding(mod, alloc, 0, plen, state)}
        if prefill:
            sched.running[1] = _prefilling(mod, alloc, 1, slot=1)
        plan = sched.schedule(spec_drafts={0: np.asarray(draft, np.int32)})
        plans.append(({k: list(v) for k, v in plan.spec.items()},
                      [r.req_id for r in plan.decode],
                      [(r.req_id, n) for r, n in plan.prefill],
                      plan.num_tokens, sched.num_spec_sheds,
                      sched.num_preemptions))
    assert plans[0] == plans[1]
    spec, _, chunks, num_tokens, sheds, preempts = plans[0]
    assert {"plans_spec_lanes": (spec, num_tokens) == ({0: [7, 8, 9]}, 4),
            "budget_split_with_prefill": (spec, chunks, num_tokens)
            == ({0: [7, 8]}, [(1, 2)], 5),
            "trim_to_budget": (spec, num_tokens) == ({0: [7, 8]}, 3),
            "shed_before_preempt": (spec, num_tokens, sheds, preempts)
            == ({}, 1, 1, 0)}[case]


# ------------------------------------------------------------ engine level
def _starved_prompts(vocab):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, (4,), dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, (2 + i,),
                                                 dtype=np.int32)])
            for i in range(4)]


def _serve(mod, cfg_mod_serve, model, params, cfg, *, num_blocks=8,
           spec="off", proposer=None, attn_impl="ragged", **kw):
    serve = cfg_mod_serve(model=cfg.name, kv_block_size=4, max_batch=3,
                          spec=spec, spec_k=3, attn_impl=attn_impl)
    eng = mod.ServingEngine(model, params, cfg, serve, num_blocks=num_blocks,
                            proposer=proposer, **kw)
    for i, p in enumerate(_starved_prompts(cfg.vocab_size)):
        eng.submit(mod.Request(req_id=i, prompt=p, max_new_tokens=10,
                               priority=i % 2,
                               deadline=float(i) if i % 2 else None))
    return eng


def test_verify_step_logits_match_jax(models):
    """A drafted step's (B, R, V) logits at ``logit_lanes``, on the same
    lanes, ragged and chunked (the port's attention metadata gives each
    drafted lane an owner of its own; the math is the reference's)."""
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    for attn_impl in ("ragged", "chunked"):
        ej = _serve(jengine, JServeConfig, model_j, params_j, cfg_j,
                    num_blocks=32, spec="ngram", attn_impl=attn_impl)
        et = _serve(tengine, ServeConfig, model_t, params_t, cfg_t,
                    num_blocks=32, spec="ngram", attn_impl=attn_impl,
                    device="cpu")
        for _ in range(20):
            plan_j = ej.scheduler.schedule(spec_drafts=ej._propose())
            plan_t = et.scheduler.schedule(spec_drafts=et._propose())
            if plan_t.spec and plan_t.prefill:
                break
            for eng, plan in ((ej, plan_j), (et, plan_t)):
                if plan.spec:
                    eng._step_sync(plan, 0.0, 0.0)
                else:
                    eng._resolve(eng._build(plan, 0.0, 0.0), None)
        assert plan_t.spec and plan_t.prefill, "no drafted mixed step"
        lists_j, tokens_j, _, _, _, _ = ej._render(plan_j)
        lists_t, tokens_t, _, _, spec_t, _ = et._render(plan_t)
        assert spec_t is not None and set(lists_t) == set(lists_j)
        np.testing.assert_array_equal(tokens_t, np.asarray(tokens_j))
        for k in ("token_pos", "slots", "last_lane", "logit_lanes"):
            np.testing.assert_array_equal(lists_t[k], np.asarray(lists_j[k]))
        # the port's attention owners: a drafted request's lanes one each,
        # keys up to the lane; every other lane its slot, as in JAX
        n = plan_t.num_tokens
        owner, pos = lists_t["token_req"][:n], lists_t["token_pos"][:n]
        slot_j = np.asarray(lists_j["token_req"])[:n]
        kvl = lists_t["kv_lens"][owner]
        drafted = np.isin(slot_j, [r.slot for r in plan_t.decode
                                   if r.req_id in plan_t.spec])
        assert drafted.sum() > len(plan_t.spec)
        np.testing.assert_array_equal(kvl[drafted], pos[drafted] + 1)
        assert len(set(owner[drafted])) == drafted.sum()
        np.testing.assert_array_equal(owner[~drafted], slot_j[~drafted])
        np.testing.assert_array_equal(
            kvl[~drafted], np.asarray(lists_j["kv_lens"])[slot_j[~drafted]])
        ej.sync_pools()
        et.sync_pools()
        logits_j, _ = model_j.decode_tokens_paged(
            params_j, ej.pools, lists_j, tokens_j,
            attn_backend=ej.attn_backend, attn_impl=attn_impl,
            **ej.attn_tunables)
        logits_t = et._forward(plan_t, lists_t, torch.from_numpy(tokens_t))
        assert logits_t.shape == logits_j.shape == (
            len(lists_t["last_lane"]), 4, cfg_t.vocab_size)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   atol=1e-4, rtol=0)


_COUNTERS = ("steps", "preemptions", "prefix_hits", "prefix_misses",
             "cow_copies", "output_tokens", "slot_compactions")


@pytest.fixture(scope="module")
def serial(models):
    """The port's draftless engine on the starved workload: the oracle."""
    _, (cfg_t, model_t, params_t) = models
    eng = _serve(tengine, ServeConfig, model_t, params_t, cfg_t,
                 device="cpu")
    eng.run_until_done()
    assert eng.metrics()["preemptions"] > 0
    return {r.req_id: list(r.output) for r in eng.finished}


@pytest.mark.parametrize("spec", ["ngram", "draft-model"])
def test_spec_engine_matches_jax_and_the_serial_engine(models, drafts,
                                                       serial, spec):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    prop_j = prop_t = None
    if spec == "draft-model":
        (dj, pj), (dt, pt) = drafts
        prop_j = jspec.DraftModelProposer(model=dj, params=pj)
        prop_t = tspec.DraftModelProposer(model=dt, params=pt)
    ej = _serve(jengine, JServeConfig, model_j, params_j, cfg_j, spec=spec,
                proposer=prop_j)
    et = _serve(tengine, ServeConfig, model_t, params_t, cfg_t, spec=spec,
                proposer=prop_t, device="cpu")
    ej.run_until_done()
    et.run_until_done()
    out_t = {r.req_id: list(r.output) for r in et.finished}
    assert out_t == {r.req_id: list(r.output) for r in ej.finished}
    assert out_t == serial
    mj, mt = ej.metrics(), et.metrics()
    assert mt["spec"] == mj["spec"]
    for key in _COUNTERS:
        assert mt[key] == mj[key], key
    s = mt["spec"]
    assert s["proposer"] == spec and s["drafted_steps"] > 0
    if spec == "ngram":
        # rejected tails truncated, drafts shed under the starved pool
        assert s["proposed_tokens"] > s["accepted_tokens"] > 0
        assert s["spec_sheds"] > 0
    assert mt["blocks_free"] == 8
    et.alloc.check_invariants(drained=True)


def test_engine_refuses_a_stochastic_proposer(models):
    _, (cfg_t, model_t, params_t) = models

    class _Stochastic(tspec.Proposer):
        name = "stochastic-test"
        deterministic = False

    with pytest.raises(ValueError, match="deterministic"):
        _serve(tengine, ServeConfig, model_t, params_t, cfg_t,
               proposer=_Stochastic(), device="cpu")


class _Scripted(tspec.Proposer):
    """Drafts from the known draftless continuation: all right, or all
    wrong (each token moved by one)."""

    name = "scripted"

    def __init__(self, outputs, vocab, wrong):
        super().__init__()
        self.outputs, self.vocab, self.wrong = outputs, vocab, wrong

    def propose(self, req, k):
        nxt = self.outputs[req.req_id][len(req.output):][:k]
        return np.asarray([(t + self.wrong) % self.vocab for t in nxt],
                          np.int32)


@pytest.mark.parametrize("wrong", [0, 1])
def test_scripted_drafts_accept_all_or_roll_back_all(models, serial, wrong):
    """Perfect drafts are all accepted; wrong ones are all rejected, their
    reserved blocks rolled back, and nothing leaks: the streams stay the
    draftless engine's either way."""
    _, (cfg_t, model_t, params_t) = models
    prop = _Scripted(serial, cfg_t.vocab_size, wrong)
    eng = _serve(tengine, ServeConfig, model_t, params_t, cfg_t,
                 proposer=prop, num_blocks=32 if not wrong else 8,
                 device="cpu")
    eng.run_until_done()
    assert {r.req_id: list(r.output) for r in eng.finished} == serial
    s = eng.metrics()["spec"]
    if wrong:
        assert s["acceptance_rate"] == 0.0 and s["rollback_blocks"] > 0
        assert s["tokens_per_decode_lane"] == 1.0
    else:
        assert s["acceptance_rate"] == 1.0 and s["rollback_blocks"] == 0
        assert s["tokens_per_decode_lane"] > 2.0
    eng.alloc.check_invariants(drained=True)
