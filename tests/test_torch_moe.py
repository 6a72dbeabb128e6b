"""The port's MoE layer and MoE serving against the JAX package's.

``moe_apply`` on the same inputs and bridged parameters as
``repro.layers.moe.moe_apply``, float32, atol 1e-5: full capacity and
capacity dropping, ``groups`` 1 and 2, with a shared expert and without,
and the load-balance loss.  The reference's two layer tests run on the
port.  Reduced granite-moe-1b-a400m and qwen3-moe-235b-a22b: ``forward``
logits, one fused ``decode_tokens_paged`` step and ``decode_step_paged``
against JAX at atol 1e-4, and the serving engine's greedy streams
identical to the JAX engine's through the ragged and chunked kernels'
plain versions and with the ``ngram`` proposer."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JaxMoEConfig
from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.layers import moe as jmoe
from repro.models.api import build_model as jax_build_model
from repro.serving import engine as jengine
from repro_torch.config import MoEConfig, ServeConfig, get_config
from repro_torch.core.paged_kv import BlockAllocator, make_pool
from repro_torch.layers import moe as tmoe
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
D = 16


def _layer(shared: int, capacity_factor: float):
    """Both configs, the JAX parameters and the port's bridged copy."""
    kw = dict(num_experts=4, top_k=2, d_expert=8,
              capacity_factor=capacity_factor, d_shared_expert=shared)
    params_j = jmoe.moe_init(jax.random.PRNGKey(3), D, JaxMoEConfig(**kw))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    return JaxMoEConfig(**kw), MoEConfig(**kw), params_j, params_t


@pytest.mark.parametrize("shared", [0, 8], ids=["routed", "shared"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("full_capacity,capacity_factor",
                         [(True, 1.25), (False, 0.5), (False, 1.25)],
                         ids=["full", "dropping", "cf1.25"])
def test_moe_apply_matches_jax(full_capacity, capacity_factor, groups,
                               shared):
    m_j, m_t, params_j, params_t = _layer(shared, capacity_factor)
    x = np.random.default_rng(0).standard_normal((2, 12, D)).astype(
        np.float32)
    want, aux_j = jmoe.moe_apply(params_j, jnp.asarray(x), m_j,
                                 full_capacity=full_capacity, groups=groups)
    got, aux_t = tmoe.moe_apply(params_t, torch.from_numpy(x), m_t,
                                full_capacity=full_capacity, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-5,
                               rtol=0)


def test_moe_dropping_drops_the_reference_tokens():
    """At a capacity of one token an expert keeps exactly the reference's
    token: the outputs' zero rows (every expert dropped the token) agree."""
    m_j, m_t, params_j, params_t = _layer(0, 0.01)
    x = np.random.default_rng(1).standard_normal((1, 32, D)).astype(
        np.float32)
    want, _ = jmoe.moe_apply(params_j, jnp.asarray(x), m_j)
    got, _ = tmoe.moe_apply(params_t, torch.from_numpy(x), m_t)
    dropped = np.all(np.asarray(want) == 0, axis=-1)
    assert 0 < dropped.sum() < 32
    np.testing.assert_array_equal(np.all(got.numpy() == 0, axis=-1), dropped)


def test_top_k_takes_the_lower_index_first_among_ties():
    x = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.5]])
    vals, idx = tmoe._top_k(x, 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[1, 3, 4, 0]]
    assert vals.tolist() == np.asarray(want_v).tolist()


def test_moe_routing_conservation():
    """The reference's test_layers.py::test_moe_routing_conservation."""
    m = MoEConfig(num_experts=4, top_k=2, d_expert=16, capacity_factor=2.0)
    gen = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(gen, 8, m)
    x = torch.randn((2, 16, 8), generator=gen)
    out, aux = tmoe.moe_apply(params, x, m)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux) > 0.0


def test_moe_capacity_dropping():
    """The reference's test_layers.py::test_moe_capacity_dropping: with
    capacity_factor near 0 the outputs shrink toward zero."""
    m_small = MoEConfig(num_experts=4, top_k=2, d_expert=16,
                        capacity_factor=0.01)
    m_big = dataclasses.replace(m_small, capacity_factor=4.0)
    gen = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(gen, 8, m_big)
    x = torch.randn((2, 32, 8), generator=gen)
    out_small, _ = tmoe.moe_apply(params, x, m_small)
    out_big, _ = tmoe.moe_apply(params, x, m_big)
    assert out_small.abs().sum() < out_big.abs().sum()


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        cfg_j = jax_get_config(arch).reduced(dtype="float32")
        model_j = jax_build_model(cfg_j, remat=False)
        params_j = model_j.init(jax.random.PRNGKey(0))
        cfg_t = get_config(arch).reduced(dtype="float32")
        model_t = build_model(cfg_t, device="cpu")
        params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                     device="cpu")
        _MODELS[arch] = ((cfg_j, model_j, params_j),
                         (cfg_t, model_t, params_t))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    (_, model_j, params_j), (cfg_t, model_t, params_t) = _models(arch)
    assert cfg_t.moe is not None and "moe" in params_t["layers"]
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 12),
                                             dtype=np.int32)
    want, aux_j = model_j.forward(params_j, jnp.asarray(toks))
    got, aux_t = model_t.forward(params_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_matches_jax(arch):
    """The paper path at full capacity: 6 tokens of 2 requests."""
    (_, model_j, params_j), (cfg_t, model_t, params_t) = _models(arch)
    a = cfg_t.attention
    B, S, BS = 2, 6, 4
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S),
                                             dtype=np.int32)
    pk, pv = make_pool(cfg_t.num_layers, 8, BS, a.num_kv_heads, a.head_dim,
                       torch.float32, "cpu")
    pools_t = {"k": pk, "v": pv}
    pools_j = {"k": jnp.zeros(pk.shape), "v": jnp.zeros(pv.shape)}
    alloc = BlockAllocator(num_blocks=8, block_size=BS)
    for r in range(B):
        alloc.allocate(r, 0)
    for t in range(S):
        slots = alloc.write_slots(list(range(B)))
        bl, br, bp, lens = alloc.build_block_list(list(range(B)), 8)
        lists = dict(block_list=bl, block_req=br, block_pos=bp,
                     seq_lens=lens, slots=slots)
        want, pools_j = model_j.decode_step_paged(
            params_j, pools_j, {k: jnp.asarray(v) for k, v in lists.items()},
            jnp.asarray(toks[:, t]))
        got, pools_t = model_t.decode_step_paged(
            params_t, pools_t, {k: torch.from_numpy(v)
                                for k, v in lists.items()},
            torch.from_numpy(toks[:, t]), num_lanes=B)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        for r in range(B):
            alloc.commit_token(r)


def _engines(arch, **kw):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = _models(arch)
    ej = jengine.ServingEngine(
        model_j, params_j, cfg_j,
        JaxServeConfig(model=cfg_j.name, kv_block_size=4, max_batch=4,
                       prefill_chunk=8, **kw), num_blocks=64)
    et = tengine.ServingEngine(
        model_t, params_t, cfg_t,
        ServeConfig(model=cfg_t.name, kv_block_size=4, max_batch=4,
                    prefill_chunk=8, **kw), num_blocks=64, device="cpu")
    rng = np.random.default_rng(2)
    base = rng.integers(0, cfg_t.vocab_size, (6,), dtype=np.int32)
    prompts = [np.tile(base, 3),                      # repeats for ngram
               rng.integers(0, cfg_t.vocab_size, (9,), dtype=np.int32),
               rng.integers(0, cfg_t.vocab_size, (14,), dtype=np.int32),
               np.tile(base, 2)]
    for i, p in enumerate(prompts):
        ej.submit(jengine.Request(req_id=i, prompt=p, max_new_tokens=6,
                                  arrival=float(i)))
        et.submit(tengine.Request(req_id=i, prompt=p, max_new_tokens=6,
                                  arrival=float(i)))
    return ej, et


@pytest.mark.parametrize("kw", [dict(), dict(attn_impl="chunked"),
                                dict(spec="ngram", spec_k=3)],
                         ids=["ragged", "chunked", "ngram"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_streams_match_jax(arch, kw):
    ej, et = _engines(arch, **kw)
    ej.run_until_done()
    et.run_until_done()
    assert ({r.req_id: list(r.output) for r in et.finished}
            == {r.req_id: list(r.output) for r in ej.finished})
    mj, mt = ej.metrics(), et.metrics()
    for key in ("steps", "output_tokens", "prefix_hits", "preemptions"):
        assert mt[key] == mj[key], key
    if "spec" in kw:
        assert mt["spec"]["accepted_tokens"] == mj["spec"]["accepted_tokens"]
    et.alloc.check_invariants(drained=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_step_logits_match_jax(arch):
    """One mixed ``decode_tokens_paged`` step on the same rendered lists."""
    ej, et = _engines(arch)
    for _ in range(2):
        ej.step()
        et.step()
    plan_j, plan_t = ej.scheduler.schedule(), et.scheduler.schedule()
    lists_j, tokens_j, *_ = ej._render(plan_j)
    lists_t, tokens_t, *_ = et._render(plan_t)
    assert np.array_equal(tokens_j, tokens_t)
    want, _ = ej.model.decode_tokens_paged(
        ej.params, ej.pools, {k: jnp.asarray(v) for k, v in lists_j.items()},
        jnp.asarray(tokens_j))
    got, _ = et.model.decode_tokens_paged(
        et.params, et.pools, {k: torch.from_numpy(v)
                              for k, v in lists_t.items()},
        torch.from_numpy(tokens_t), attn_tunables=et.attn_tunables)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
