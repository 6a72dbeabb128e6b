"""The port's dense flash attention on the CPU against the JAX package: the
plain version and the wrapper (a CPU tensor takes the plain version)
against ``repro.kernels.flash_attention.ref`` and the Pallas kernel in
interpret mode, at ``tests/test_kernels.py``'s flash shapes.

Tolerances: float32 atol 1e-5 against the jnp reference (the same one-pass
softmax, summed in another order) and 2e-3 against the Pallas kernel (an
online softmax over 64-key tiles), as ``tests/test_kernels.py`` holds the
kernel; bfloat16 atol 2e-2 against both (the scores and weights are
rounded to bfloat16 at other places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention.ops import (check_shapes,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

# tests/test_kernels.py's (B, S, H, KV, hd, causal, dtype), then
# smollm-360m's grouping (15 q heads over 5 kv heads) at a short sequence
CASES = [(2, 128, 4, 2, 64, True, "float32"),
         (1, 256, 6, 6, 64, False, "float32"),
         (2, 64, 8, 2, 128, True, "float32"),
         (1, 128, 4, 4, 64, True, "bfloat16"),
         (1, 64, 15, 5, 64, True, "float32")]


def _inputs(B, S, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,dtype", CASES)
def test_flash_matches_jax_ref_and_pallas(B, S, H, KV, hd, causal, dtype):
    (qj, kj, vj), (q, k, v) = _inputs(B, S, H, KV, hd, dtype)
    plain = flash_attention_ref(q, k, v, causal=causal)
    assert plain.shape == q.shape and plain.dtype == q.dtype
    assert torch.equal(flash_attention(q, k, v, causal=causal, bq=64,
                                       bk=64), plain)
    want = jax_ref(qj, kj, vj, causal=causal)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, bq=64, bk=64,
                                    interpret=True)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(_np(plain), _np(want), rtol=0,
                               atol=2e-2 if bf16 else 1e-5)
    np.testing.assert_allclose(_np(plain), _np(pallas), rtol=0,
                               atol=2e-2 if bf16 else 2e-3)


def test_flash_sm_scale_and_causal_rows():
    (qj, kj, vj), (q, k, v) = _inputs(1, 32, 4, 2, 16, "float32", seed=1)
    got = flash_attention_ref(q, k, v, causal=True, sm_scale=0.3)
    np.testing.assert_allclose(
        _np(got), _np(jax_ref(qj, kj, vj, causal=True, sm_scale=0.3)),
        rtol=0, atol=1e-5)
    # causal row 0 sees only key 0: its output is v[0] of its kv head
    np.testing.assert_allclose(_np(got[:, 0]),
                               _np(v[:, 0].repeat_interleave(2, dim=1)),
                               rtol=0, atol=1e-6)


def test_flash_cpu_does_not_count_launches():
    _, (q, k, v) = _inputs(*CASES[0][:5], "float32")
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before


def test_flash_refuses_what_the_tpu_grid_refuses():
    _, (q, k, v) = _inputs(1, 96, 4, 2, 16, "float32")
    flash_attention(q, k, v, bq=32, bk=96)        # 96 % 32 == 0
    with pytest.raises(ValueError):               # 96 % 64 != 0
        flash_attention(q, k, v, bq=64)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, bq=32, bk=64)
    with pytest.raises(ValueError):               # k of another length
        flash_attention(q, k[:, :64], v[:, :64], bq=32, bk=32)
    with pytest.raises(ValueError):               # 4 q heads over 3
        check_shapes(q, k[:, :, :1].repeat(1, 1, 3, 1),
                     v[:, :, :1].repeat(1, 1, 3, 1), 32, 32)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)
