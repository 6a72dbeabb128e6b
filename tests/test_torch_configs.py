"""The port's decoder configs against the JAX package's: llama31-8b
(the paper's LLM), llama31-70b, qwen2-1.5b (QKV bias), qwen3-32b
(qk_norm), internlm2-20b and smollm-360m, and the MoE configs
granite-moe-1b-a400m and qwen3-moe-235b-a22b (their fields; the MoE
models are held to JAX in ``tests/test_torch_moe.py``).

Fields equal the reference's, full and reduced; at reduced float32 widths
with bridged parameters (biases and qk-norm scales perturbed away from
their zero / one init so that they count) ``forward`` and one mixed
``decode_tokens_paged`` step agree with JAX within atol 1e-4, and the
engine's greedy streams are identical to the JAX engine's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.serving import engine as jengine
from repro_torch.config import ModelConfig, ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine

LMS = ["smollm-360m", "llama31-8b", "llama31-70b", "qwen2-1.5b",
       "qwen3-32b", "internlm2-20b"]
NEW = LMS[1:]


def _fields(cfg_t, cfg_j):
    """(name, port value, reference value) for every field of the port's
    ModelConfig, the attention, MoE, SSM and RWKV sub-configs field by
    field."""
    for f in dataclasses.fields(ModelConfig):
        got, want = getattr(cfg_t, f.name), getattr(cfg_j, f.name)
        if f.name in ("attention", "moe", "ssm", "rwkv") and got is not None:
            for g in dataclasses.fields(got):
                yield (f"{f.name}.{g.name}", getattr(got, g.name),
                       getattr(want, g.name))
        else:
            yield f.name, got, want


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LMS)
def test_config_fields_equal_the_reference(arch, reduced):
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg_t, cfg_j = (c.reduced(dtype="float32") for c in (cfg_t, cfg_j))
    diff = [(n, g, w) for n, g, w in _fields(cfg_t, cfg_j) if g != w]
    assert diff == []
    assert cfg_j.moe is None and cfg_j.attention.window == 0
    if arch == "llama31-8b" and reduced:
        a = cfg_t.attention
        assert (a.num_heads, a.num_kv_heads, a.head_dim) == (4, 1, 16)


MOE = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_config_fields_equal_the_reference(arch, reduced):
    """The two MoE configs, full and reduced (the reference's MoE branch:
    4 experts, top-2, d_expert 32), field by field."""
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg_t, cfg_j = (c.reduced(dtype="float32") for c in (cfg_t, cfg_j))
    diff = [(n, g, w) for n, g, w in _fields(cfg_t, cfg_j) if g != w]
    assert diff == []
    assert cfg_t.family == "moe" and cfg_t.moe is not None
    if reduced:
        m = cfg_t.moe
        assert (m.num_experts, m.top_k, m.d_expert) == (4, 2, 32)


FAMILIES = ["rwkv6-1.6b", "zamba2-2.7b", "whisper-tiny", "internvl2-26b"]


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_config_fields_equal_the_reference(arch, reduced):
    """The other families' configs, full and reduced (the reference's
    ssm / rwkv / encoder / vision overrides), field by field."""
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg_t, cfg_j = (c.reduced(dtype="float32") for c in (cfg_t, cfg_j))
    diff = [(n, g, w) for n, g, w in _fields(cfg_t, cfg_j) if g != w]
    assert diff == []
    assert cfg_t.source == cfg_j.source and cfg_t.source


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", LMS + MOE + FAMILIES)
def test_num_params_equal_the_reference(arch, reduced):
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg_t, cfg_j = (c.reduced(dtype="float32") for c in (cfg_t, cfg_j))
    assert cfg_t.num_params() == cfg_j.num_params()


@pytest.mark.parametrize("arch", ["smollm-360m"] + FAMILIES)
def test_depth_units_and_with_depth_equal_the_reference(arch):
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    assert cfg_t.depth_units == cfg_j.depth_units
    for units in (1, 3):
        got, want = cfg_t.with_depth(units), cfg_j.with_depth(units)
        assert [(n, g) for n, g, w in _fields(got, want) if g != w] == []


_MODELS = {}


def _models(arch):
    """JAX model and params (biases and qk-norm scales perturbed), and the
    port's model with the bridged params; built once per arch."""
    if arch not in _MODELS:
        cfg_j = jax_get_config(arch).reduced(dtype="float32")
        model_j = jax_build_model(cfg_j, remat=False)
        params_j = model_j.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        attn = dict(params_j["layers"]["attn"])
        for name in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if name in attn:
                attn[name] = jax.tree.map(
                    lambda x: x + jnp.asarray(
                        rng.standard_normal(x.shape) * 0.1, x.dtype),
                    attn[name])
        params_j = dict(params_j, layers=dict(params_j["layers"], attn=attn))
        cfg_t = get_config(arch).reduced(dtype="float32")
        model_t = build_model(cfg_t, device="cpu")
        params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                     device="cpu")
        _MODELS[arch] = (cfg_j, model_j, params_j), (cfg_t, model_t,
                                                     params_t)
    return _MODELS[arch]


def _lists(NB):
    # slot 1 decodes position 6; slot 0 prefills positions 2..6; 2 padding
    # lanes.  Block size 4: slot 1 holds blocks [3, 5], slot 0 [1, 6].
    return {
        "block_list": [3, 5, 1, 6] + [0] * (NB - 4),
        "block_req": [1, 1, 0, 0] + [2] * (NB - 4),
        "block_pos": [0, 1, 0, 1] + [0] * (NB - 4),
        "kv_lens": [7, 7],
        "token_req": [1, 0, 0, 0, 0, 0, 2, 2],
        "token_pos": [6, 2, 3, 4, 5, 6, 0, 0],
        "cu_q_lens": [0, 1, 6], "cu_kv_lens": [0, 7, 14],
        "seq_slot": [1, 0],
        "slots": [(5, 2), (1, 2), (1, 3), (6, 0), (6, 1), (6, 2), (NB, 0),
                  (NB, 0)],
        "last_lane": [5, 0],
    }


@pytest.mark.parametrize("arch", NEW)
def test_forward_and_mixed_step_match_jax(arch):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = _models(arch)
    attn = params_t["layers"]["attn"]
    assert ("bq" in attn) == cfg_t.attention.qkv_bias
    assert ("q_norm" in attn) == cfg_t.attention.qk_norm
    assert ("head" in params_t) == (not cfg_t.tie_embeddings)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 11)).astype(np.int32)
    want, _ = model_j.forward(params_j, jnp.asarray(toks))
    got, _ = model_t.forward(params_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)

    a = cfg_t.attention
    NB, BS = 8, 4
    pool = rng.standard_normal((cfg_t.num_layers, NB, BS,
                                2 * a.num_kv_heads,
                                a.head_dim)).astype(np.float32)
    tokens = rng.integers(0, cfg_t.vocab_size, (8,)).astype(np.int32)
    lists = {k: np.asarray(v, np.int32) for k, v in _lists(NB).items()}
    logits_j, pools_j = model_j.decode_tokens_paged(
        params_j, {"kv": jnp.asarray(pool)},
        {k: jnp.asarray(v) for k, v in lists.items()}, jnp.asarray(tokens))
    logits_t, pools_t = model_t.decode_tokens_paged(
        params_t, {"kv": torch.from_numpy(pool.copy())},
        {k: torch.from_numpy(v) for k, v in lists.items()},
        torch.from_numpy(tokens))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(pools_t["kv"].numpy(),
                               np.asarray(pools_j["kv"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["llama31-8b", "qwen2-1.5b", "qwen3-32b"])
def test_engine_greedy_streams_match_jax(arch):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = _models(arch)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg_t.vocab_size, (12,), dtype=np.int32)
    prompts = [shared,
               rng.integers(0, cfg_t.vocab_size, (9,), dtype=np.int32),
               rng.integers(0, cfg_t.vocab_size, (14,), dtype=np.int32),
               shared.copy()]
    kw = dict(kv_block_size=4, max_batch=4, prefill_chunk=8)
    ej = jengine.ServingEngine(model_j, params_j, cfg_j,
                               JaxServeConfig(model=cfg_j.name, **kw),
                               num_blocks=32)
    et = tengine.ServingEngine(model_t, params_t, cfg_t,
                               ServeConfig(model=cfg_t.name, **kw),
                               num_blocks=32, device="cpu")
    for e, mod in ((ej, jengine), (et, tengine)):
        for i, p in enumerate(prompts):
            e.submit(mod.Request(req_id=i, prompt=p, max_new_tokens=6,
                                 arrival=float(i)))
        e.run_until_done()
    out_j = {r.req_id: list(r.output) for r in ej.finished}
    out_t = {r.req_id: list(r.output) for r in et.finished}
    assert out_t == out_j
    mj, mt = ej.metrics(), et.metrics()
    for key in ("steps", "prefix_hits", "cow_copies", "output_tokens"):
        assert mt[key] == mj[key], key
    et.alloc.check_invariants(drained=True)
