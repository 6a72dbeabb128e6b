"""The port's GPipe pipeline and int8 compressed all-reduce on gloo ranks,
against the JAX package's functions and formulas, on the CPU.

* Pipeline, at the reference test's sizes (``tests/test_distributed.py``
  ``test_pipeline_matches_reference``: S 4 stages, M 6 microbatches of 2,
  D 8, stage s applying ``tanh(h @ ws[s])``): every rank's output equals
  the stages applied in turn by JAX within 1e-5, and ``bubble_fraction``
  is the reference's exactly.
* Compression: ``quantize_int8`` / ``dequantize_int8`` match JAX's bit for
  bit; ``compressed_psum`` over 4 ranks (one (64,) gradient a rank, zero
  residual) equals a numpy restatement of the reference's formula exactly
  (the scale's MAX, the int32 SUM, the float32 mean and residual), is
  within 0.1 of the float32 mean on every rank with a residual below 0.2,
  as the reference test asks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jcomp
from repro.distributed import pipeline as jpipe
from repro_torch.bench import sharded_train as st
from repro_torch.distributed import compression, pipeline
from repro_torch.launch import mesh as mesh_lib

S, M, MB, D = 4, 6, 2, 8


def test_pipeline_matches_the_stages_in_turn():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    ref = jnp.asarray(x)
    for s in range(S):
        ref = jnp.tanh(ref @ jnp.asarray(ws[s]))
    outs = mesh_lib.run_ranks(st.pipeline_job, S, (ws, x), timeout=120)
    for out in outs:
        assert out.shape == (M, MB, D)
        np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("stages,micro", [(4, 6), (4, 8), (1, 3), (8, 1)])
def test_bubble_fraction_is_the_reference_s(stages, micro):
    assert pipeline.bubble_fraction(stages, micro) == jpipe.bubble_fraction(
        stages, micro)
    assert pipeline.bubble_fraction(4, 6) == 3 / 9


def test_quantize_int8_bitwise_matches_jax():
    rng = np.random.default_rng(1)
    for x in (rng.standard_normal(256).astype(np.float32) * 3,
              np.linspace(-2.5, 2.5, 255, dtype=np.float32),
              np.zeros(7, np.float32)):
        q, s = compression.quantize_int8(torch.from_numpy(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert q.dtype == torch.int8
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, s).numpy(),
            np.asarray(jcomp.dequantize_int8(jq, js)))


def _numpy_compressed_psum(g):
    """The reference's ``compressed_psum`` over the rows of g (one a rank),
    restated in numpy float32."""
    comp = g.astype(np.float32)
    scale = np.maximum(np.abs(comp).max(axis=1), np.float32(1e-12)) \
        / np.float32(127.0)
    gscale = scale.max()
    q = np.clip(np.round(comp / gscale), -127, 127).astype(np.int8)
    summed = q.astype(np.int32).sum(axis=0)
    reduced = summed.astype(np.float32) * gscale / np.float32(g.shape[0])
    return reduced, comp - q.astype(np.float32) * gscale


def test_compressed_psum_over_four_ranks():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 64)).astype(np.float32)
    ranks = mesh_lib.run_ranks(st.compression_job, 4, (g,), timeout=120)
    want, resid = _numpy_compressed_psum(g)
    mean = g.mean(axis=0)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["reduced"], want)
        np.testing.assert_array_equal(got["residual"], resid[r])
        np.testing.assert_allclose(got["reduced"], mean, atol=0.1)
        assert np.abs(got["residual"]).max() < 0.2


def test_init_residuals_and_wire_bytes():
    tree = {"a": torch.ones((3, 4), dtype=torch.bfloat16),
            "b": [torch.ones(5)]}
    res = compression.init_residuals(tree)
    assert res["a"].dtype == torch.float32 and res["a"].shape == (3, 4)
    assert float(res["b"][0].abs().sum()) == 0
    assert compression.wire_bytes(tree) == {
        "int8": 17 + 8, "int32_as_sent": 68 + 8, "float32": 68}
