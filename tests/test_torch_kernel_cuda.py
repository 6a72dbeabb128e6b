"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: ragged, chunked and decode paged attention, the BatchedTable
embedding bag, STREAM, row gather/scatter and dense flash attention.
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
rounding of the last bf16 digit).  STREAM and gather/scatter: bitwise (the
kernels round as the plain versions do, and move rows as raw bytes).
Flash attention: float32 atol 2e-5 and bfloat16 atol 2e-2, as for paged
attention.  In bfloat16 also every element within 2^-7 (M + |want|) + 1e-4
of the plain version on float32 q and k, M the same on |v|: with the scores
in float32, as the kernel takes them, the two differ only where each rounds
the weights and the output to bfloat16, so a fault in small outputs shows.
``bq``/``bk`` change no bit.
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.gather_scatter import ops as gs
from repro_torch.kernels.gather_scatter import ref as gs_ref
from repro_torch.kernels.stream import ops as stream
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


STREAM_ROWS = 2048                      # divisible by every block_rows


def _bits(t):
    """The tensor's bit pattern, so that NaNs compare too."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("block_rows", [8, 64, 256, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_kernels_equal_plain_versions_bitwise(card, dtype,
                                                     block_rows):
    gen = torch.Generator(device=card)
    gen.manual_seed(block_rows)
    n = STREAM_ROWS * stream.LANES
    a = torch.randn(n, generator=gen, device=card).to(dtype)
    b = torch.randn(n, generator=gen, device=card).to(dtype)
    for scalar in (3.0, 0.1):               # 0.1 is rounded to the dtype
        for op, args in ((stream.stream_add, (a, b)),
                         (stream.stream_scale, (a, scalar)),
                         (stream.stream_triad, (a, b, scalar))):
            before = op.launches
            got = op(*args, block_rows)
            torch.cuda.synchronize()
            assert op.launches == before + 1
            assert got.dtype == dtype and got.shape == (n,)
            assert torch.equal(_bits(got), _bits(op.plain(*args, block_rows)))


def test_stream_kernels_refuse_bad_inputs(card):
    a = torch.ones(128 * 3, device=card)
    with pytest.raises(ValueError):            # 3 rows, block_rows 2
        stream.stream_add(a, a, 2)
    with pytest.raises(ValueError):            # not whole rows
        stream.stream_scale(a[:200], 2.0, 1)
    with pytest.raises(TypeError):
        stream.stream_add(a.half(), a.half(), 1)
    with pytest.raises(ValueError):            # 4-byte aligned only
        stream.stream_triad(torch.ones(385, device=card)[1:], a, 2.0, 1)


# (R, D, N, dtype): Fig 9's row widths at small R, with N > R so that ids
# repeat, and rows that are not a multiple of 16 bytes (element loads).
GS_CASES = [(1000, 4, 3000, torch.float32), (1000, 16, 3000, torch.float32),
            (500, 64, 2000, torch.float32), (500, 512, 2000, torch.float32),
            (300, 3, 1000, torch.float32), (300, 8, 1000, torch.bfloat16),
            (300, 5, 1000, torch.bfloat16)]


def _gs_inputs(dev, R, D, N, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    table = torch.randn((R, D), generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, R, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:4] = torch.tensor([-1, -R, R, -R - 1], device=dev)   # wrap, NaN/drop
    idx[4] = 2 ** 31 - 1
    idx[-1] = idx[5]                         # a repeat: the last one wins
    src = torch.randn((N, D), generator=gen, device=dev).to(dtype)
    return table, idx, src


@pytest.mark.parametrize("R,D,N,dtype", GS_CASES)
def test_gather_kernel_equals_plain_version_bitwise(card, R, D, N, dtype):
    table, idx, _ = _gs_inputs(card, R, D, N, dtype)
    before = gs.vector_gather.launches
    got = gs.vector_gather(table, idx)
    torch.cuda.synchronize()
    assert gs.vector_gather.launches == before + 1
    assert torch.equal(_bits(got), _bits(gs_ref.gather_ref(table, idx)))
    nan = torch.isnan(got).all(dim=1)
    assert nan.nonzero().view(-1).tolist() == [2, 3, 4]


@pytest.mark.parametrize("R,D,N,dtype", GS_CASES)
def test_scatter_kernel_equals_plain_version_bitwise(card, R, D, N, dtype):
    table, idx, src = _gs_inputs(card, R, D, N, dtype)
    want = gs_ref.scatter_ref(table, idx, src)
    before = gs.vector_scatter_.launches
    got = gs.vector_scatter(table, idx, src)
    torch.cuda.synchronize()
    assert gs.vector_scatter_.launches == before + 1
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(got, table)       # vector_scatter left it alone
    again = table.clone()
    assert gs.vector_scatter_(again, idx, src) is again
    assert torch.equal(_bits(again), _bits(want))
    assert torch.equal(got[idx[5]], src[-1])  # the last write of a repeat


def test_gather_scatter_address_past_2_31_bytes(card):
    """A 2.2 M x 256 float32 table (2.25 GB): rows near its top."""
    R, D, N = 2_200_000, 256, 4096
    table = torch.arange(R, device=card, dtype=torch.float32)[:, None]
    table = table.expand(R, D).contiguous()
    idx = torch.arange(R - N, R, device=card, dtype=torch.int32).flip(0)
    got = gs.vector_gather(table, idx)
    assert torch.equal(got[:, 0].long(), idx.long())
    src = -torch.ones((N, D), device=card)
    gs.vector_scatter_(table, idx, src)
    torch.cuda.synchronize()
    assert bool((table[R - N:] == -1).all())
    assert bool((table[:R - N, 0] >= 0).all())


def test_gather_scatter_refuse_bad_inputs(card):
    table, idx, src = _gs_inputs(card, 10, 4, 8, torch.float32)
    with pytest.raises(TypeError):
        gs.vector_gather(table, idx.long())
    with pytest.raises(TypeError):
        gs.vector_gather(table.half(), idx)
    with pytest.raises(ValueError):
        gs.vector_gather(table, idx.cpu())
    with pytest.raises(ValueError):
        gs.vector_scatter_(table, idx, src[:, :3])
    with pytest.raises(TypeError):
        gs.vector_scatter_(table, idx, src.bfloat16())


# (B, S, H, KV, hd, dtype): tests/test_kernels.py's flash sweep, then
# smollm-360m's and Fig 17's head widths at a short sequence.
FLASH_CASES = [(2, 128, 4, 2, 64, torch.float32),
               (1, 256, 6, 6, 64, torch.float32),
               (2, 64, 8, 2, 128, torch.float32),
               (1, 128, 4, 4, 64, torch.bfloat16),
               (1, 512, 15, 5, 64, torch.bfloat16),
               (2, 256, 32, 8, 128, torch.bfloat16),
               (1, 100, 4, 1, 16, torch.float32)]


def _flash_inputs(dev, B, S, H, KV, hd, dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain_version(card, B, S, H, KV, hd, dtype,
                                            causal):
    q, k, v = _flash_inputs(card, B, S, H, KV, hd, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, bq=S, bk=S)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= atol
    if dtype == torch.bfloat16:
        want = flash_attention_ref(q.float(), k.float(), v,
                                   causal=causal).float()
        m = flash_attention_ref(q.float(), k.float(), v.abs(),
                                causal=causal).float()
        assert ((got.float() - want).abs()
                <= 2 ** -7 * (m + want.abs()) + 1e-4).all()
    if S % 64 == 0:                         # the TPU tiles change no bit
        assert torch.equal(got, flash_attention(q, k, v, causal=causal,
                                                bq=64, bk=64))


def test_flash_kernel_refuses_bad_inputs(card):
    q, k, v = _flash_inputs(card, 1, 96, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError):            # 96 % 64
        flash_attention(q, k, v, bq=64)
    with pytest.raises(ValueError):            # k of another length
        flash_attention(q, k[:, :64], v[:, :64], bq=32, bk=32)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), bq=32, bk=32)
    with pytest.raises(ValueError):            # head dim 48
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), bq=32, bk=32)
    with pytest.raises(ValueError):
        flash_attention(q, k, v.cpu(), bq=32, bk=32)
