"""The port's ragged paged attention (plain PyTorch version) against the JAX
package: lane metadata integer-exact, outputs against the jnp reference
and against the Pallas kernel in interpret mode, float32, atol 1e-5; and
the bf16 limit the card holds the kernels to, met by the Pallas kernel in
bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention_api as japi
from repro.kernels.paged_attention.kernel import paged_attention_ragged_pallas
from repro_torch.core import attention_api as tapi
from repro_torch.kernels.paged_attention.cases import (
    ARG_ORDER, SMALL, SMALL_CASES, ragged_case)

CASES = SMALL_CASES


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    return ragged_case(rng, **dict(SMALL, **CASES[name]))


def _torch_args(c):
    return [torch.from_numpy(c[k]) for k in ARG_ORDER]


def _jax_args(c):
    return [jnp.asarray(c[k]) for k in ARG_ORDER]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_lane_metadata_is_exact(name):
    c = _case(name)
    S, T = len(c["seq_slot"]), c["q"].shape[0]
    got = tapi.ragged_lane_metadata(torch.from_numpy(c["cu_q_lens"]),
                                    torch.from_numpy(c["cu_kv_lens"]),
                                    torch.from_numpy(c["seq_slot"]), T, S)
    want = japi.ragged_lane_metadata(jnp.asarray(c["cu_q_lens"]),
                                     jnp.asarray(c["cu_kv_lens"]),
                                     jnp.asarray(c["seq_slot"]), T, S)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_ragged_matches_jax_reference(name):
    c = _case(name)
    got = tapi.paged_attention_ragged(*_torch_args(c)).numpy()
    want = np.asarray(japi.paged_attention_ragged(*_jax_args(c)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # padding lanes and lanes with no valid key read 0
    pad_from = int(c["cu_q_lens"][-1])
    assert np.all(got[pad_from:] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_ragged_matches_pallas_interpret(name):
    c = _case(name, seed=1)
    got = tapi.paged_attention_ragged(*_torch_args(c)).numpy()
    want = np.asarray(paged_attention_ragged_pallas(
        *_jax_args(c), num_queries_per_block=4, num_kv_pages_per_block=2,
        interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_ragged_lane_chunking_is_exact(monkeypatch):
    c = _case("mixed")
    whole = tapi.paged_attention_ragged(*_torch_args(c))
    monkeypatch.setattr(tapi, "_PLAIN_SCORE_ELEMS", 1)   # one lane a chunk
    chunked = tapi.paged_attention_ragged(*_torch_args(c))
    assert torch.equal(whole, chunked)


def test_op_on_cpu_takes_plain_version_and_counts_nothing():
    c = _case("mixed")
    before = tapi.paged_attention_ragged_op.launches
    out = tapi.paged_attention_ragged_op(*_torch_args(c))
    assert torch.equal(out, tapi.paged_attention_ragged(*_torch_args(c)))
    assert tapi.paged_attention_ragged_op.launches == before


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_limit_holds_for_the_reference_kernel(name):
    """The card's bf16 limit for the ragged and chunked kernels
    (``ragged_bf16_share`` at most 1, as chip_smoke.py and the card tests
    hold them) is met by the Pallas ragged kernel in bf16, which rounds
    the weights for the PV product and sums l unrounded as the kernels do.
    Outputs under 0.25 moved by 8 ulps do not meet it."""
    c = _case(name, seed=3)
    args = _torch_args(c)
    args[:2] = [a.bfloat16() for a in args[:2]]
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             if a.is_floating_point() else jnp.asarray(a.numpy())
             for a in args]
    pallas = torch.from_numpy(np.asarray(paged_attention_ragged_pallas(
        *jargs, num_queries_per_block=4, num_kv_pages_per_block=2,
        interpret=True).astype(jnp.float32))).bfloat16()
    assert tapi.ragged_bf16_share(pallas, *args) <= 1
    small = (pallas.float().abs() < 0.25).to(torch.int16)
    control = (pallas.view(torch.int16) + 8 * small).view(torch.bfloat16)
    assert tapi.ragged_bf16_share(control, *args) > 1
