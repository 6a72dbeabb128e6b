"""The layers of the port's other model families against the JAX
package's, float32 on the CPU, on parameters initialised by JAX (every
leaf perturbed away from its constant init) and bridged, inputs from a
numpy seed:

* ``layernorm`` (default eps and 1e-6): atol 1e-6;
* the GELU MLP (tanh approximation, as ``jax.nn.gelu``): atol 1e-5; the
  ``act`` rule: ``"gelu"`` is the GELU MLP, anything else the SwiGLU;
* cross-attention over ``encode_kv`` (biases on): atol 1e-5;
* RWKV6: ``time_mix_chunked`` over two chunks and under one (atol 1e-5),
  and with a decay strong enough that an unmasked exponent would overflow
  (atol 2e-4, see the test); ``time_mix_step`` over 8 tokens;
  ``channel_mix`` with and without a carried shift: atol 1e-5; the steps
  equal the chunked form within atol 1e-4;
* Mamba2: ``ssm_chunked`` over two chunks and under one, ``ssm_step``
  over 16 tokens, ``_causal_conv`` with a carried window: atol 1e-5; the
  steps equal the chunked form within atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JAttention
from repro.config import RWKVConfig as JRWKV
from repro.config import SSMConfig as JSSM
from repro.layers import attention as jattn
from repro.layers import mlp as jmlp
from repro.layers import norm as jnorm
from repro.layers import rwkv as jrwkv
from repro.layers import ssm as jssm
from repro_torch.config import AttentionConfig, RWKVConfig, SSMConfig
from repro_torch.layers import attention, mlp, norm, rwkv, ssm
from repro_torch.models.bridge import params_from_numpy

D, B = 64, 2


def _bridge(params_j, seed=1, scale=0.05):
    """JAX params, each leaf perturbed -> (jax tree, torch tree)."""
    rng = np.random.default_rng(seed)
    params_j = jax.tree.map(
        lambda x: x + jnp.asarray(rng.standard_normal(x.shape) * scale,
                                  x.dtype), params_j)
    return params_j, params_from_numpy(jax.tree.map(np.asarray, params_j),
                                       device="cpu")


def _x(shape, seed=2):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layernorm_matches_jax(eps):
    pj, pt = _bridge(jnorm.layernorm_init(D), scale=0.3)
    xj, xt = _x((3, 5, D))
    _close(norm.layernorm(pt, xt * 3 + 1, eps),
           jnorm.layernorm(pj, xj * 3 + 1, eps), 1e-6)
    assert norm.layernorm(pt, xt.bfloat16()).dtype == torch.bfloat16


def test_gelu_mlp_matches_jax():
    pj, pt = _bridge(jmlp.gelu_mlp_init(jax.random.PRNGKey(0), D, 128))
    xj, xt = _x((B, 7, D))
    got = mlp.mlp_apply(pt, xt, "gelu")
    _close(got, jmlp.mlp_apply(pj, xj, "gelu"), 1e-5)
    h = torch.matmul(xt, pt["w_in"]) + pt["b_in"]
    exact = torch.matmul(torch.nn.functional.gelu(h), pt["w_out"]) \
        + pt["b_out"]
    assert (exact - got).abs().max() > 1e-5      # the erf form differs


@pytest.mark.parametrize("act", ["gelu", "silu", "relu"])
def test_mlp_init_follows_the_reference_rule(act):
    want = jmlp.mlp_init(jax.random.PRNGKey(0), D, 32, act)
    got = mlp.mlp_init(torch.Generator().manual_seed(0), D, 32, act)
    assert sorted(got) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    pj, pt = _bridge(want)
    xj, xt = _x((B, 3, D))
    _close(mlp.mlp_apply(pt, xt, act), jmlp.mlp_apply(pj, xj, act), 1e-5)


def test_cross_attention_matches_jax():
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True)
    aj, at = JAttention(**kw), AttentionConfig(**kw)
    pj, pt = _bridge(jattn.attention_init(jax.random.PRNGKey(0), D, aj),
                     scale=0.2)
    encj, enct = _x((B, 12, D), seed=3)
    xj, xt = _x((B, 5, D))
    kvj = jattn.encode_kv(pj, encj, aj)
    kvt = attention.encode_kv(pt, enct, at)
    for a, b in zip(kvt, kvj):
        _close(a, b, 1e-5)
    _close(attention.cross_attention_block(pt, xt, kvt, at),
           jattn.cross_attention_block(pj, xj, kvj, aj), 1e-5)


RW = dict(head_size=16, decay_lora=8)


def _rwkv(w0=None):
    key = jax.random.PRNGKey(0)
    pj, pt = _bridge(jrwkv.rwkv_time_mix_init(key, D, JRWKV(**RW)))
    if w0 is not None:     # a decay of exp(w0) a step
        pj = dict(pj, w0=jnp.full((D,), w0, jnp.float32))
        pt = dict(pt, w0=torch.full((D,), w0))
    return pj, pt


@pytest.mark.parametrize("S,w0,atol", [(64, None, 1e-5), (8, None, 1e-5),
                                        (64, 2.0, 2e-4)],
                         ids=["two_chunks", "under_a_chunk", "strong_decay"])
def test_time_mix_chunked_matches_jax(S, w0, atol):
    """strong_decay: exp(2) a step, so a chunk's log decays reach -236 and
    an unmasked exp(+236) would overflow; with the history decayed away
    ``ln_out`` normalises small outputs, which widens float32 rounding
    differences to 2e-4."""
    pj, pt = _rwkv(w0)
    xj, xt = _x((B, S, D))
    got = rwkv.time_mix_chunked(pt, xt, RWKVConfig(**RW))
    assert torch.isfinite(got).all()
    _close(got, jrwkv.time_mix_chunked(pj, xj, JRWKV(**RW)), atol)


def test_time_mix_step_matches_jax_and_the_chunked_form():
    pj, pt = _rwkv()
    xj, xt = _x((B, 8, D))
    sj = {"shift": jnp.zeros((B, D)), "S": jnp.zeros((B, 4, 16, 16))}
    st = {"shift": torch.zeros((B, D)), "S": torch.zeros((B, 4, 16, 16))}
    outs = []
    for t in range(8):
        oj, sj = jrwkv.time_mix_step(pj, xj[:, t:t + 1], sj, JRWKV(**RW))
        ot, st = rwkv.time_mix_step(pt, xt[:, t:t + 1], st, RWKVConfig(**RW))
        _close(ot, oj, 1e-5)
        outs.append(ot)
    _close(st["S"], sj["S"], 1e-5)
    _close(torch.cat(outs, 1),
           rwkv.time_mix_chunked(pt, xt, RWKVConfig(**RW)).numpy(), 1e-4)


@pytest.mark.parametrize("carried", [False, True])
def test_channel_mix_matches_jax(carried):
    pj, pt = _bridge(jrwkv.rwkv_channel_mix_init(jax.random.PRNGKey(0), D,
                                                 128))
    xj, xt = _x((B, 6, D))
    pvj, pvt = _x((B, D), seed=4) if carried else (None, None)
    oj, lj = jrwkv.channel_mix(pj, xj, pvj)
    ot, lt = rwkv.channel_mix(pt, xt, pvt)
    _close(ot, oj, 1e-5)
    _close(lt, lj, 0)


def test_rwkv_init_state_matches_jax():
    got = rwkv.rwkv_init_state(B, D, RWKVConfig(**RW))
    want = jrwkv.rwkv_init_state(B, D, JRWKV(**RW))
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (v.shape, torch.float32) for k, v in want.items()}


SS = dict(d_state=16, head_dim=16, chunk_size=16)


def _ssm():
    return _bridge(jssm.ssm_init(jax.random.PRNGKey(0), D, JSSM(**SS)))


@pytest.mark.parametrize("S", [32, 8], ids=["two_chunks", "under_a_chunk"])
def test_ssm_chunked_matches_jax(S):
    pj, pt = _ssm()
    xj, xt = _x((B, S, D))
    _close(ssm.ssm_chunked(pt, xt, SSMConfig(**SS), D),
           jssm.ssm_chunked(pj, xj, JSSM(**SS), D), 1e-5)


def test_ssm_step_matches_jax_and_the_chunked_form():
    pj, pt = _ssm()
    xj, xt = _x((B, 16, D))
    sj = jssm.ssm_init_state(B, D, JSSM(**SS))
    st = ssm.ssm_init_state(B, D, SSMConfig(**SS))
    assert {k: tuple(v.shape) for k, v in st.items()} == {
        k: v.shape for k, v in sj.items()}
    outs = []
    for t in range(16):
        oj, sj = jssm.ssm_step(pj, xj[:, t:t + 1], sj, JSSM(**SS), D)
        ot, st = ssm.ssm_step(pt, xt[:, t:t + 1], st, SSMConfig(**SS), D)
        _close(ot, oj, 1e-5)
        outs.append(ot)
    _close(st["h"], sj["h"], 1e-5)
    _close(st["conv"], sj["conv"], 1e-5)
    _close(torch.cat(outs, 1),
           ssm.ssm_chunked(pt, xt, SSMConfig(**SS), D).numpy(), 1e-4)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_jax(carried):
    pj, pt = _ssm()
    xj, xt = _x((B, 5, 160))
    pvj, pvt = _x((B, 3, 160), seed=5) if carried else (None, None)
    oj, nj = jssm._causal_conv(xj, pj["conv_w"], pj["conv_b"], pvj)
    ot, nt = ssm._causal_conv(xt, pt["conv_w"], pt["conv_b"], pvt)
    _close(ot, oj, 1e-6)
    _close(nt, nj, 0)
