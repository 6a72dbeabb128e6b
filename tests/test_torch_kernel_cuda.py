"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: ragged, chunked and decode paged attention and the BatchedTable
embedding bag.
Marked ``cuda``: without a card with ``nvcc`` these skip.  No JAX here, so
the file also runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

Tolerances, attention: float32 atol 2e-5 (the kernel's online softmax sums
in another order than the plain version's one-pass softmax); bfloat16 atol
2e-2 (the plain version rounds scores to bfloat16, the kernel keeps them
in float32); the same for chunked and decode.  Chunked and ragged (and
decode and chunked) share their per-row device code, so on the same lanes
they must agree bitwise.  Embedding bag: float32 atol 1e-5 and bfloat16 atol 2e-2
(both sum in float32 in the order of the bag; the bound is for the card's
rounding of the last bf16 digit).
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.core import attention_api as api
from repro_torch.core import embedding_api as emb_api
from repro_torch.core.paged_kv import fused_kv_views
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.cases import (
    ARG_ORDER, CHUNKED_ARG_ORDER, CHUNKED_CASES, DECODE_ARG_ORDER,
    DECODE_CASES, SMALL, SMALL_CASES, chunked_case, decode_case, ragged_case)

pytestmark = pytest.mark.cuda

FULL = dict(num_heads=15, num_kv=5, head_dim=64, block_size=16,
            num_blocks=96)
FULL_CASE = dict(seqs=[(3, 1, 300), (0, 37, 37), (5, 1, 17), (1, 120, 250),
                       (2, 1, 1), (8, 0, 0), (8, 0, 0), (8, 0, 0)],
                 num_lanes=256, num_entries=128)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    if not (os.path.exists(build.nvcc_path()) or shutil.which("nvcc")):
        pytest.skip("no nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _args(c, dtype, dev):
    out = []
    for k in ARG_ORDER:
        t = torch.from_numpy(c[k]).to(dev)
        out.append(t.to(dtype) if t.is_floating_point() else t)
    return out


CASES = [(SMALL, SMALL_CASES[n]) for n in sorted(SMALL_CASES)]
CASES.append((FULL, FULL_CASE))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,case", CASES)
def test_kernel_matches_plain_version(card, shape, case, dtype, atol):
    c = ragged_case(np.random.default_rng(0), **shape, **case)
    args = _args(c, dtype, card)
    before = api.paged_attention_ragged_op.launches
    got = api.paged_attention_ragged_op(*args)
    torch.cuda.synchronize()
    assert api.paged_attention_ragged_op.launches == before + 1
    want = api.paged_attention_ragged(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err
    pad_from = int(c["cu_q_lens"][-1])
    assert torch.all(got[pad_from:] == 0)


def test_kernel_refuses_bad_inputs(card):
    c = ragged_case(np.random.default_rng(0), **SMALL,
                    **SMALL_CASES["mixed"])
    args = _args(c, torch.float32, card)
    with pytest.raises(TypeError):
        api.paged_attention_ragged_op(args[0].half(), args[1].half(),
                                      *args[2:])
    with pytest.raises(ValueError):
        api.paged_attention_ragged_op(args[0], args[1].cpu(), *args[2:])


# smollm-360m's widths: owners interleaved within a tile, an empty request
# (slot 2), runs longer than a tile, padding lanes.
FULL_CHUNKED = dict(kv_lens=[300, 37, 0, 250, 17],
                    lanes=[(0, 299), (3, 130), (0, 298), (4, 16), (2, 0)]
                    + [(1, p) for p in range(37)]
                    + [(3, p) for p in range(130, 250)] + [(5, 0)] * 12,
                    num_entries=64, shuffle=True)
FULL_DECODE = dict(seq_lens=[300, 1, 0, 250, 16, 17, 700], num_entries=96)
CHUNKED = [(SMALL, CHUNKED_CASES[n]) for n in sorted(CHUNKED_CASES)]
CHUNKED.append((FULL, FULL_CHUNKED))
DECODE = [(SMALL, DECODE_CASES[n]) for n in sorted(DECODE_CASES)]
DECODE.append((FULL, FULL_DECODE))
DTYPES = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


def _chunked_args(c, dtype, dev):
    q = torch.from_numpy(c["q"]).to(dev, dtype)
    pool = torch.from_numpy(c["kv_pool"]).to(dev, dtype)
    ints = [torch.from_numpy(c[k]).to(dev) for k in CHUNKED_ARG_ORDER]
    return [q, *fused_kv_views(pool), *ints]


@pytest.mark.parametrize("q_chunk,depth", [(16, 0), (4, 2)])
@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape,case", CHUNKED)
def test_chunked_kernel_matches_plain_version(card, shape, case, dtype, atol,
                                              q_chunk, depth):
    c = chunked_case(np.random.default_rng(0), **shape, **case)
    args = _chunked_args(c, dtype, card)
    before = api.paged_attention_chunked_op.launches
    got = api.paged_attention_chunked_op(*args, q_chunk=q_chunk,
                                         prefetch_depth=depth)
    torch.cuda.synchronize()
    assert api.paged_attention_chunked_op.launches == before + 1
    want = api.paged_attention_chunked(*args)
    assert (got.float() - want.float()).abs().max().item() <= atol
    kvl = np.append(c["kv_lens"], 0)
    dead = kvl[np.minimum(c["token_req"], len(c["kv_lens"]))] == 0
    assert torch.all(got[torch.from_numpy(dead).to(card)] == 0)
    # the tunables change no result
    again = api.paged_attention_chunked_op(*args)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,case", CASES)
def test_chunked_kernel_equals_ragged_kernel_bitwise(card, shape, case,
                                                     dtype):
    c = ragged_case(np.random.default_rng(0), **shape, **case)
    q, pool, bl, br, bp, cu_q, cu_kv, ss = _args(c, dtype, card)
    ragged = api.paged_attention_ragged_op(q, pool, bl, br, bp, cu_q, cu_kv,
                                           ss)
    treq, tpos, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                               ss.shape[0])
    chunked = api.paged_attention_chunked_op(q, *fused_kv_views(pool), bl,
                                             br, bp, kvl, treq, tpos)
    torch.cuda.synchronize()
    assert torch.equal(ragged, chunked)


def _decode_args(c, dtype, dev):
    return [torch.from_numpy(c[k]).to(dev).to(dtype)
            if c[k].dtype == np.float32 else torch.from_numpy(c[k]).to(dev)
            for k in DECODE_ARG_ORDER]


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape,case", DECODE)
def test_decode_kernel_matches_plain_version(card, shape, case, dtype, atol):
    c = decode_case(np.random.default_rng(0), **shape, **case)
    args = _decode_args(c, dtype, card)
    before = api.paged_attention_op.launches
    got = api.paged_attention_op(*args)
    torch.cuda.synchronize()
    assert api.paged_attention_op.launches == before + 1
    want = api.paged_attention_opt(*args)
    assert (got.float() - want.float()).abs().max().item() <= atol
    empty = torch.from_numpy(c["seq_lens"] == 0).to(card)
    assert torch.all(got[empty] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_equals_chunked_kernel_bitwise(card, dtype):
    c = decode_case(np.random.default_rng(1), **FULL, **FULL_DECODE)
    q, pk, pv, bl, br, bp, lens = _decode_args(c, dtype, card)
    decode = api.paged_attention_op(q, pk, pv, bl, br, bp, lens)
    B = q.shape[0]
    chunked = api.paged_attention_chunked_op(
        q, pk, pv, bl, br, bp, lens,
        torch.arange(B, dtype=torch.int32, device=card), lens - 1)
    torch.cuda.synchronize()
    assert torch.equal(decode, chunked)


def test_chunked_and_decode_kernels_refuse_bad_inputs(card):
    c = chunked_case(np.random.default_rng(0), **SMALL,
                     **CHUNKED_CASES["runs"])
    q, pk, pv, *ints = _chunked_args(c, torch.float32, card)
    with pytest.raises(ValueError):
        api.paged_attention_chunked_op(q, pk, pv, *ints, q_chunk=0)
    with pytest.raises(ValueError):
        api.paged_attention_chunked_op(q, pk, pv, *ints, prefetch_depth=-1)
    with pytest.raises(TypeError):
        api.paged_attention_chunked_op(q, pk.half(), pv.half(), *ints)
    with pytest.raises(ValueError):            # rows 4 bytes apart
        api.paged_attention_chunked_op(q, pk[..., 1:].contiguous(),
                                       pv[..., 1:].contiguous(), *ints)
    with pytest.raises(ValueError):
        api.paged_attention_chunked_op(q, pk, pv.contiguous(), *ints)
    with pytest.raises(TypeError):
        api.paged_attention_chunked_op(q, pk, pv, *ints[:-1],
                                       ints[-1].long())
    d = decode_case(np.random.default_rng(0), **SMALL,
                    **DECODE_CASES["sorted"])
    args = _decode_args(d, torch.float32, card)
    with pytest.raises(ValueError):
        api.paged_attention_op(*args[:-1], args[-1][:-1])
    with pytest.raises(ValueError):
        api.paged_attention_op(args[0], args[1].cpu(), *args[2:])


# (rows per table, D, B, T, L): RM1's and RM2's widths at small R, the
# embedding sweep's narrowest and widest rows, one id per bag, and the
# kernel's narrowest row (16 bytes: bf16 D=8) and widest (2048 bytes: f32
# D=512).
EMB_CASES = [(1000, 128, 64, 10, 10), (1000, 64, 64, 20, 20),
             (512, 16, 8, 4, 20), (512, 256, 8, 4, 20), (100, 128, 3, 2, 1),
             (64, 8, 8, 2, 5), (64, 512, 4, 2, 3)]
EMB_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


def _emb_inputs(dev, R, D, B, T, L, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tbl = torch.randn((R * T, D), generator=gen, device=dev).to(dtype)
    offs = torch.arange(T, dtype=torch.int32, device=dev) * R
    idx = torch.randint(0, R, (B, T, L), generator=gen, device=dev,
                        dtype=torch.int32)
    return tbl, offs, idx


def _emb_err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype,atol", EMB_DTYPES)
@pytest.mark.parametrize("case", EMB_CASES)
def test_embedding_kernel_matches_plain_version(card, case, dtype, atol):
    tbl, offs, idx = _emb_inputs(card, *case, dtype)
    if idx.shape[2] > 2:
        idx[:, :, 2] = idx[:, :, 0]            # a duplicate id in each bag
    before = emb_api.embedding_bag.launches
    got = emb_api.embedding_bag(tbl, offs, idx)
    torch.cuda.synchronize()
    assert emb_api.embedding_bag.launches == before + 1
    assert got.dtype == dtype and got.shape == (*idx.shape[:2], tbl.shape[1])
    want = emb_api.batched_table_lookup(tbl, offs, idx)
    assert _emb_err(got, want) <= atol


@pytest.mark.parametrize("dtype,atol", EMB_DTYPES)
def test_embedding_kernel_out_of_range_ids(card, dtype, atol):
    R, D, B, T, L = 50, 64, 6, 3, 4
    tbl, offs, idx = _emb_inputs(card, R, D, B, T, L, dtype, seed=1)
    Rt = R * T
    idx[0, 0, 1] = Rt                   # past the end: NaN
    idx[1, 2, 0] = -2 * R - 1           # global -1: the last row
    idx[2, 0, 3] = -Rt                  # global -Rt: row 0
    idx[3, 1, 2] = -Rt - R - 1          # below -Rt: NaN
    idx[4, 2, 0] = 2 ** 31 - 1 - 2 * R  # the largest id: NaN
    got = emb_api.embedding_bag(tbl, offs, idx)
    want = emb_api.batched_table_lookup(tbl, offs, idx)
    torch.cuda.synchronize()
    nan = torch.isnan(got).all(dim=-1)
    assert torch.equal(nan, torch.isnan(want).all(dim=-1))
    assert torch.equal(torch.isnan(got).any(dim=-1), nan)
    assert sorted(map(tuple, nan.nonzero().tolist())) == [
        (0, 0), (3, 1), (4, 2)]
    assert _emb_err(got[~nan], want[~nan]) <= atol


def test_embedding_kernel_addresses_past_2_31_bytes(card):
    """A 9 M x 64 float32 table (2.3 GB): ids near its top read the right
    rows, which a 32-bit row offset would not."""
    R, D, B, L = 9_000_000, 64, 64, 20
    tbl = torch.empty((R, D), device=card)
    tbl[:R // 2] = 1.0
    tbl[R // 2:] = torch.arange(R - R // 2, device=card,
                                dtype=torch.float32)[:, None] / R
    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    idx = torch.randint(R - 100_000, R, (B, 1, L), generator=gen,
                        device=card, dtype=torch.int32)
    offs = torch.zeros((1,), dtype=torch.int32, device=card)
    got = emb_api.embedding_bag(tbl, offs, idx)
    want = emb_api.batched_table_lookup(tbl, offs, idx)
    torch.cuda.synchronize()
    assert _emb_err(got, want) <= 1e-5
    direct = tbl[idx.long().view(-1)].view(B, 1, L, D).sum(dim=2)
    assert _emb_err(got, direct) <= 1e-4
    assert (got > 1.0).all()            # no row of the lower half was read


def test_embedding_kernel_refuses_bad_inputs(card):
    tbl, offs, idx = _emb_inputs(card, 10, 64, 2, 3, 4, torch.float32)
    with pytest.raises(TypeError):
        emb_api.embedding_bag(tbl, offs, idx.long())
    with pytest.raises(TypeError):
        emb_api.embedding_bag(tbl.half(), offs, idx)
    with pytest.raises(ValueError):
        emb_api.embedding_bag(tbl, offs, idx.cpu())
    with pytest.raises(ValueError):                 # 24-byte rows
        emb_api.embedding_bag(tbl[:, :6].contiguous(), offs, idx)
    with pytest.raises(ValueError):                 # 4096-byte rows
        emb_api.embedding_bag(tbl.repeat(1, 16), offs, idx)
    flat = torch.zeros(30 * 64 + 1, device=card)
    with pytest.raises(ValueError):                 # 4-byte aligned only
        emb_api.embedding_bag(flat[1:].view(30, 64), offs, idx)
