"""The sharded attention and embedding ops of the port against the JAX
package's single-device ops on the whole pool and table, on the CPU.

One input (numpy, seeded): a fused pool of 16 blocks of 4 keys, 2 kv
heads of 4 q heads, head dim 16, float32; a prefill chunk of 5 lanes
whose pages lie on two ranks, a decode lane whose blocks all lie on
another rank than the first, a decode lane of one block, and 3 padding
lanes.  On S in {2, 4} gloo ranks (one spawn each) every rank cuts its
pool block and LOCAL BlockList with the allocator's render and runs
``paged_attention_ragged_sharded`` / ``_chunked_sharded`` /
``paged_attention_sharded`` and ``batched_table_lookup_sharded``; the
combined results must equal JAX's ``paged_attention_ragged`` /
``paged_attention_chunked`` / ``paged_attention_opt`` and
``batched_table_lookup`` within 1e-5 (the ranks sum the partials in
another order than one device), and every rank must hold the same bits.

The statistics the kernels' plain versions return beside their output
(``with_stats``) are held to the reference's ``_chunked_partials`` /
``_opt_partials`` in one process.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention_api as japi
from repro.core import embedding_api as jemb
from repro.core import paged_kv as jpk
from repro_torch.bench import sharded
from repro_torch.core import attention_api as api
from repro_torch.core import embedding_api as emb
from repro_torch.launch import mesh as mesh_lib

NB, BS, KV, G, HD = 16, 4, 2, 2, 16
H = KV * G
ATOL = 1e-5
# (owner, its pages (global blocks), its lanes, its keys)
OWNERS = [(0, [1, 9, 2], 5, 10),       # a prefill chunk over two ranks
          (1, [10, 11], 1, 7),         # a decode lane on one other rank
          (2, [3], 1, 4)]              # a decode lane of one block
PAD_LANES = 3


def _inputs():
    rng = np.random.default_rng(0)
    O = len(OWNERS)
    T = sum(n for _, _, n, _ in OWNERS) + PAD_LANES
    kv_pool = rng.standard_normal((NB, BS, 2 * KV, HD)).astype(np.float32)
    q = rng.standard_normal((T, H, HD)).astype(np.float32)
    token_req = np.full((T,), O, np.int32)
    token_pos = np.zeros((T,), np.int32)
    kv_lens = np.zeros((O,), np.int32)
    cu_q, cu_kv = [0], [0]
    lane = 0
    for owner, _, n, keys in OWNERS:
        token_req[lane:lane + n] = owner
        token_pos[lane:lane + n] = keys - n + np.arange(n)
        kv_lens[owner] = keys
        cu_q.append(cu_q[-1] + n)
        cu_kv.append(cu_kv[-1] + keys)
        lane += n
    bl = np.zeros((NB,), np.int32)
    br = np.full((NB,), O, np.int32)
    bp = np.zeros((NB,), np.int32)
    c = 0
    for owner, pages, _, _ in OWNERS:
        bl[c:c + len(pages)] = pages
        br[c:c + len(pages)] = owner
        bp[c:c + len(pages)] = np.arange(len(pages))
        c += len(pages)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    return dict(
        kv_pool=kv_pool, q=q, token_req=token_req, token_pos=token_pos,
        kv_lens=kv_lens, cu_q_lens=np.asarray(cu_q, np.int32),
        cu_kv_lens=np.asarray(cu_kv, np.int32),
        seq_slot=np.arange(O, dtype=np.int32), pad_req=O,
        owner_pages=[(o, p) for o, p, _, _ in OWNERS],
        flat=(bl, br, bp),
        decode_q=rng.standard_normal((O, H, HD)).astype(np.float32),
        decode_pages=[(o, p) for o, p, _, _ in OWNERS],
        seq_lens=np.asarray([k for *_, k in OWNERS], np.int32),
        table=table, offsets=np.asarray([0, 32], np.int32),
        indices=rng.integers(0, 32, (3, 2, 4), dtype=np.int32))


def _reference(inp):
    bl, br, bp = (jnp.asarray(a) for a in inp["flat"])
    pool = jnp.asarray(inp["kv_pool"])
    pk, pv = jpk.fused_kv_views(pool)
    q = jnp.asarray(inp["q"])
    return {
        "ragged": japi.paged_attention_ragged(
            q, pool, bl, br, bp, jnp.asarray(inp["cu_q_lens"]),
            jnp.asarray(inp["cu_kv_lens"]), jnp.asarray(inp["seq_slot"])),
        "chunked": japi.paged_attention_chunked(
            q, pk, pv, bl, br, bp, jnp.asarray(inp["kv_lens"]),
            jnp.asarray(inp["token_req"]), jnp.asarray(inp["token_pos"])),
        "decode": japi.paged_attention_opt(
            jnp.asarray(inp["decode_q"]), pk, pv, bl, br, bp,
            jnp.asarray(inp["seq_lens"])),
        "lookup": jemb.batched_table_lookup(
            jnp.asarray(inp["table"]), jnp.asarray(inp["offsets"]),
            jnp.asarray(inp["indices"])),
    }


@pytest.fixture(scope="module")
def case():
    inp = _inputs()
    return inp, {k: np.asarray(v) for k, v in _reference(inp).items()}


def test_the_input_has_the_lanes_it_names(case):
    inp, _ = case
    for S in (2, 4):
        per = NB // S
        shards = {o: {b // per for b in p} for o, p, _, _ in OWNERS}
        assert len(shards[0]) == 2                 # the chunk spans ranks
        assert shards[1] != {0} and len(shards[1]) == 1
    assert (inp["token_req"] == len(OWNERS)).sum() == PAD_LANES


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_ops_equal_the_single_device_reference(case, S):
    inp, want = case
    ranks = mesh_lib.run_ranks(sharded.attention_job, S, (inp, "cpu"))
    for r, got in enumerate(ranks):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                       err_msg=f"S={S} rank {r} {k}")
            np.testing.assert_array_equal(got[k], ranks[0][k])
    pad = inp["token_req"] == len(OWNERS)
    assert np.all(ranks[0]["ragged"][pad] == 0)
    assert np.all(ranks[0]["chunked"][pad] == 0)


def test_one_rank_mesh_equals_the_plain_ops(case):
    inp, want = case
    got = sharded.attention_job(inp, "cpu")       # a mesh of one rank
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_stats_equal_the_reference_partials(case):
    inp, want = case
    bl, br, bp = (_t(a) for a in inp["flat"])
    pool = _t(inp["kv_pool"])
    pk, pv = api.paged_kv.fused_kv_views(pool)
    q = _t(inp["q"])
    scale = HD ** -0.5
    ints = (_t(inp["kv_lens"]), _t(inp["token_req"]), _t(inp["token_pos"]))
    out, m, l = api.paged_attention_chunked_op(q, pk, pv, bl, br, bp, *ints,
                                               with_stats=True)
    jm, jl, _ = japi._chunked_partials(
        jnp.asarray(inp["q"]), *jpk.fused_kv_views(
            jnp.asarray(inp["kv_pool"])), *(jnp.asarray(a)
                                            for a in inp["flat"]),
        *(jnp.asarray(inp[k]) for k in ("kv_lens", "token_req",
                                         "token_pos")), scale)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(
        out.numpy(), api.paged_attention_chunked_op(q, pk, pv, bl, br, bp,
                                                    *ints).numpy())
    np.testing.assert_allclose(out.numpy(), want["chunked"], atol=ATOL)
    pad = inp["token_req"] == len(OWNERS)
    assert np.all(m.numpy()[pad] == -1e30) and np.all(l.numpy()[pad] == 0)
    rout, rm, rl = api.paged_attention_ragged_op(
        q, pool, bl, br, bp, _t(inp["cu_q_lens"]), _t(inp["cu_kv_lens"]),
        _t(inp["seq_slot"]), with_stats=True)
    np.testing.assert_array_equal(rout.numpy(), out.numpy())
    np.testing.assert_array_equal(rm.numpy(), m.numpy())
    np.testing.assert_array_equal(rl.numpy(), l.numpy())
    dq = _t(inp["decode_q"])
    dout, dm, dl = api.paged_attention_op(dq, pk, pv, bl, br, bp,
                                          _t(inp["seq_lens"]),
                                          with_stats=True)
    jm, jl, _ = japi._opt_partials(
        jnp.asarray(inp["decode_q"]),
        *jpk.fused_kv_views(jnp.asarray(inp["kv_pool"])),
        *(jnp.asarray(a) for a in inp["flat"]), jnp.asarray(inp["seq_lens"]),
        len(OWNERS), scale)
    np.testing.assert_allclose(dm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(dout.numpy(), want["decode"], atol=ATOL)


def test_row_window_lookup_sums_only_its_rows(case):
    inp, _ = case
    table, offs, idx = (_t(inp[k]) for k in ("table", "offsets", "indices"))
    whole = emb.batched_table_lookup(table, offs, idx)
    parts = [emb.embedding_bag_window(table[lo:lo + 16], offs, idx, lo,
                                      lo + 16) for lo in range(0, 64, 16)]
    torch.testing.assert_close(sum(parts), whole, atol=1e-5, rtol=0)
    gid = (idx + offs[None, :, None]).reshape(-1)
    miss = emb.embedding_bag_window(table[48:], offs, idx, 48, 64)
    bags = (gid.reshape(3, 2, 4) >= 48).any(dim=-1)
    assert torch.all(miss[~bags] == 0)
