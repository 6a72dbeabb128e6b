"""The port's layers against the JAX package's, on the same seeded numpy
inputs, float32, atol = rtol = 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttentionConfig as JaxAttentionConfig
from repro.layers import attention as jattn
from repro.layers import embedding as jemb
from repro.layers import mlp as jmlp
from repro.layers import norm as jnorm
from repro.layers import rope as jrope
from repro_torch.config import AttentionConfig
from repro_torch.layers import attention as tattn
from repro_torch.layers import embedding as temb
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norm as tnorm
from repro_torch.layers import rope as trope

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 32), _rand(rng, 32)
    _close(tnorm.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x), 1e-5),
           jnorm.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5))


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


def test_embed_unembed_match_jax():
    rng = np.random.default_rng(2)
    table = _rand(rng, 50, 24)
    tok = rng.integers(0, 50, (9,)).astype(np.int32)
    x = _rand(rng, 4, 1, 24)
    _close(temb.embed({"table": torch.from_numpy(table)},
                      torch.from_numpy(tok)),
           jemb.embed({"table": jnp.asarray(table)}, jnp.asarray(tok)))
    _close(temb.unembed({"table": torch.from_numpy(table)},
                        torch.from_numpy(x)),
           jemb.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(3)
    p = {"w_gate": _rand(rng, 32, 48), "w_up": _rand(rng, 32, 48),
         "w_down": _rand(rng, 48, 32)}
    x = _rand(rng, 5, 1, 32)
    _close(tmlp.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), "silu"),
           jmlp.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), "silu"))


@pytest.mark.parametrize("qkv_bias,qk_norm", [(False, False), (True, False),
                                              (False, True)])
def test_project_qkv_gqa_matches_jax(qkv_bias, qk_norm):
    rng = np.random.default_rng(4)
    a = AttentionConfig(num_heads=6, num_kv_heads=2, head_dim=16,
                        qkv_bias=qkv_bias, qk_norm=qk_norm)
    ja = JaxAttentionConfig(**dataclasses.asdict(a))
    D = 32
    p = {"wq": _rand(rng, D, 96), "wk": _rand(rng, D, 32),
         "wv": _rand(rng, D, 32), "wo": _rand(rng, 96, D)}
    if qkv_bias:
        p.update(bq=_rand(rng, 96), bk=_rand(rng, 32), bv=_rand(rng, 32))
    nested = dict(p)
    if qk_norm:
        nested.update(q_norm={"scale": _rand(rng, 16)},
                      k_norm={"scale": _rand(rng, 16)})

    def tree(fn, node):
        return ({k: tree(fn, v) for k, v in node.items()}
                if isinstance(node, dict) else fn(node))

    x = _rand(rng, 4, 1, D)
    pos = rng.integers(0, 100, (4, 1)).astype(np.int32)
    outs_t = tattn.project_qkv(tree(torch.from_numpy, nested),
                               torch.from_numpy(x), a, torch.from_numpy(pos))
    outs_j = jattn.project_qkv(tree(jnp.asarray, nested), jnp.asarray(x), ja,
                               jnp.asarray(pos))
    for t, j in zip(outs_t, outs_j):
        assert tuple(t.shape) == tuple(j.shape)
        _close(t, j)
