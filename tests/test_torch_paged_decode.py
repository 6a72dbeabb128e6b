"""The port's paper path against the JAX package, on the CPU in float32:
the padded BlockTable (base) and flat BlockList (opt) plain versions, the
decode op's plain path against the Pallas decode kernel in interpret
mode, the allocator's tables, lists and slots (integer-exact), the
plain attention cores, ``forward`` and ``decode_step_paged`` with bridged
parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.core import attention_api as japi
from repro.core import paged_kv as jkv
from repro.kernels.paged_attention.kernel import paged_attention_pallas
from repro.layers import attention as jattn
from repro.models.api import build_model as jax_build_model
from repro_torch.config import get_config
from repro_torch.core import attention_api as tapi
from repro_torch.core import paged_kv as tkv
from repro_torch.kernels.paged_attention.cases import (
    DECODE_ARG_ORDER, DECODE_CASES, SMALL, decode_case)
from repro_torch.layers import attention as tattn
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy

# The reference's test_paged_attention_kernel_sweep shapes:
# (NB, BS, KV, hd, H, B, lens).
SWEEP = [(24, 8, 2, 64, 8, 3, [13, 8, 21]),
         (40, 16, 4, 128, 8, 4, [40, 1, 64, 17]),
         (16, 8, 6, 64, 6, 2, [5, 9]),
         (16, 8, 1, 64, 4, 2, [8, 16])]


def _allocators(NB, BS, lens, seed=1):
    """The port's and the reference's allocator, the same scrambled free
    list, the same requests."""
    out = []
    for cls in (tkv.BlockAllocator, jkv.BlockAllocator):
        al = cls(num_blocks=NB, block_size=BS)
        al._free = np.random.RandomState(seed).permutation(NB).tolist()
        for r, n in enumerate(lens):
            al.allocate(r, n)
        out.append(al)
    return out


def _sweep_inputs(NB, BS, KV, hd, H, B, lens):
    rng = np.random.default_rng(NB + hd)
    pk = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    tal, _ = _allocators(NB, BS, lens)
    tot = sum(-(-n // BS) for n in lens)
    maxb = max(-(-n // BS) for n in lens)
    tab, tlens = tal.build_block_table(list(range(B)), max_blocks=maxb + 1)
    lists = tal.build_block_list(list(range(B)), max_total=tot + 3)
    return q, pk, pv, (tab, tlens), lists


@pytest.mark.parametrize("NB,BS,KV,hd,H,B,lens", SWEEP)
def test_allocator_layouts_match_jax_exactly(NB, BS, KV, hd, H, B, lens):
    tal, jal = _allocators(NB, BS, lens)
    maxb = max(-(-n // BS) for n in lens) + 2
    for got, want in zip(tal.build_block_table(list(range(B)), maxb, 3),
                         jal.build_block_table(list(range(B)), maxb, 3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for total in (None, sum(-(-n // BS) for n in lens) + 5):
        for got, want in zip(tal.build_block_list(list(range(B)), total),
                             jal.build_block_list(list(range(B)), total)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for _ in range(BS + 1):         # slots across a block boundary
        np.testing.assert_array_equal(tal.write_slots(list(range(B))),
                                      jal.write_slots(list(range(B))))
        for r in range(B):
            tal.commit_token(r)
            jal.commit_token(r)
    assert tal.append_token(0) == jal.append_token(0)
    assert tal.reserve_slot(1) == jal.reserve_slot(1)
    assert all(tal.table(r) == jal.table(r) for r in range(B))
    assert all(tal.seq_len(r) == jal.seq_len(r) for r in range(B))
    with pytest.raises(ValueError):
        tal.build_block_list(list(range(B)), max_total=1)


@pytest.mark.parametrize("NB,BS,KV,hd,H,B,lens", SWEEP)
def test_base_and_opt_match_jax(NB, BS, KV, hd, H, B, lens):
    q, pk, pv, (tab, tlens), (bl, br, bp, lens2) = _sweep_inputs(
        NB, BS, KV, hd, H, B, lens)
    t = [torch.from_numpy(a) for a in (q, pk, pv)]
    j = [jnp.asarray(a) for a in (q, pk, pv)]
    got = tapi.paged_attention_base(*t, torch.from_numpy(tab),
                                    torch.from_numpy(tlens)).numpy()
    want = japi.paged_attention_base(*j, jnp.asarray(tab), jnp.asarray(tlens))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    lists = [torch.from_numpy(a) for a in (bl, br, bp, lens2)]
    got_opt = tapi.paged_attention_opt(*t, *lists).numpy()
    want_opt = japi.paged_attention_opt(*j, *map(jnp.asarray,
                                                 (bl, br, bp, lens2)))
    np.testing.assert_allclose(got_opt, np.asarray(want_opt), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_opt, got, atol=1e-5, rtol=0)


@pytest.mark.parametrize("NB,BS,KV,hd,H,B,lens", SWEEP)
def test_decode_op_on_cpu_matches_pallas_interpret(NB, BS, KV, hd, H, B,
                                                   lens):
    q, pk, pv, _, lists = _sweep_inputs(NB, BS, KV, hd, H, B, lens)
    before = tapi.paged_attention_op.launches
    got = tapi.paged_attention_op(
        *[torch.from_numpy(a) for a in (q, pk, pv, *lists)]).numpy()
    assert tapi.paged_attention_op.launches == before   # CPU: plain
    want = paged_attention_pallas(
        *[jnp.asarray(a) for a in (q, pk, pv, *lists)], interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_opt_on_cases_matches_jax_and_empty_requests_read_zero(name):
    c = decode_case(np.random.default_rng(0), **SMALL, **DECODE_CASES[name])
    got = tapi.paged_attention_opt(
        *[torch.from_numpy(c[k]) for k in DECODE_ARG_ORDER]).numpy()
    want = np.asarray(japi.paged_attention_opt(
        *[jnp.asarray(c[k]) for k in DECODE_ARG_ORDER]))
    empty = c["seq_lens"] == 0
    np.testing.assert_allclose(got[~empty], want[~empty], atol=1e-5, rtol=0)
    assert np.all(got[empty] == 0)


def test_pool_makers_match_jax():
    NB, BS, KV, HD = 8, 4, 2, 8
    pk, pv = tkv.make_pool(3, NB, BS, KV, HD, torch.float32)
    jk, _ = jkv.make_pool(3, NB, BS, KV, HD, jnp.float32)
    assert pk.shape == pv.shape == jk.shape and not pk.any()
    rng = np.random.default_rng(0)
    k_seq = rng.standard_normal((2, 8, KV, HD)).astype(np.float32)
    table = np.asarray([[5, 1], [2, 7]], np.int32)
    got = tkv.gather_prefill_into_pool(pk[0], torch.from_numpy(k_seq),
                                       table, 8, BS)
    want = jkv.gather_prefill_into_pool(jnp.zeros((NB, BS, KV, HD)),
                                        jnp.asarray(k_seq),
                                        jnp.asarray(table), 8, BS)
    assert got.data_ptr() == pk[0].data_ptr()           # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Sq,chunk,causal", [(12, 16, True), (64, 32, True),
                                             (96, 40, False), (70, 32, True)])
def test_attention_cores_match_jax(Sq, chunk, causal):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sq, 2, 16)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    got = tattn.chunked_attention(*t, causal=causal, chunk=chunk).numpy()
    want = jattn.chunked_attention(*j, causal=causal, chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    full = tattn.full_attention(*t, causal=causal).numpy()
    np.testing.assert_allclose(full, got, atol=1e-5, rtol=0)


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


def test_forward_matches_jax(models):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab_size, (2, 12),
                                             dtype=np.int32)
    want, _, (jk, jv) = model_j.forward(params_j, jnp.asarray(toks),
                                        return_kv=True)
    got, aux, (tk, tv) = model_t.forward(params_t, torch.from_numpy(toks),
                                         return_kv=True)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=0)
    last, _ = model_t.forward(params_t, torch.from_numpy(toks),
                              last_only=True)
    # the head's product at another shape: BLAS blocks it differently
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), atol=1e-5,
                               rtol=0)


def _decode_loop(model, params, pools, toks, B, BS, alloc_cls, to_dev):
    """Feed ``toks`` (B, S) one token per step through decode_step_paged,
    the allocator reserving each step's slots; stacked logits (B, S, V)."""
    al = alloc_cls(num_blocks=16, block_size=BS)
    for r in range(B):
        al.allocate(r, 0)
    outs = []
    for t in range(toks.shape[1]):
        slots = al.write_slots(list(range(B)))
        bl, br, bp, lens = al.build_block_list(list(range(B)), max_total=8)
        lists = {"block_list": bl, "block_req": br, "block_pos": bp,
                 "seq_lens": lens, "slots": slots}
        lg, pools = model.decode_step_paged(
            params, pools, {k: to_dev(v) for k, v in lists.items()},
            to_dev(toks[:, t]))
        outs.append(np.asarray(lg))
        for r in range(B):
            al.commit_token(r)
    return np.stack(outs, 1)


def test_decode_step_paged_matches_jax_and_forward(models):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    B, S, BS = 2, 12, 4
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S),
                                             dtype=np.int32)
    a = cfg_t.attention
    pk, pv = tkv.make_pool(cfg_t.num_layers, 16, BS, a.num_kv_heads,
                           a.head_dim, torch.float32)
    got = _decode_loop(model_t, params_t, {"k": pk, "v": pv}, toks, B, BS,
                       tkv.BlockAllocator, torch.from_numpy)
    jk, jv = jkv.make_pool(cfg_j.num_layers, 16, BS, a.num_kv_heads,
                           a.head_dim, jnp.float32)
    want = _decode_loop(model_j, params_j, {"k": jk, "v": jv}, toks, B, BS,
                        jkv.BlockAllocator, jnp.asarray)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    fwd, _ = model_t.forward(params_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got, fwd.numpy(), rtol=3e-3, atol=3e-3)
