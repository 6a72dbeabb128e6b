"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: ragged, chunked and decode paged attention, the BatchedTable
embedding bag, STREAM, row gather/scatter and dense flash attention.
Marked ``cuda``: without a card with ``nvcc`` these skip.  No JAX here, so
the file also runs on a machine that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py

Tolerances, attention: float32 atol 2e-5 (the kernel's online softmax sums
in another order than the plain version's one-pass softmax); bfloat16 atol
2e-2 (the plain version rounds scores to bfloat16, the kernel keeps them
in float32); the same for chunked and decode.  Ragged and chunked in
bfloat16 are also held to flash's per-element limit below
(``ragged_bf16_share``/``chunked_bf16_share``).  Chunked and ragged (and
decode and chunked) share their per-row device code and choose the tile
(tensor cores for bf16 owners of two or more lanes, SIMT otherwise) by
owner alone, so on the same lanes they must agree bitwise, whatever
``q_chunk`` is.  Embedding bag: float32 atol 1e-5 and bfloat16 atol 2e-2
(both sum in float32 in the order of the bag; the bound is for the card's
rounding of the last bf16 digit).  STREAM and gather/scatter: bitwise (the
kernels round as the plain versions do, and move rows as raw bytes);
STREAM also at the edges of its persistent grid (one row, fewer tiles than
SMs, a tile count that is not a multiple of the grid, tiles larger than a
16 KiB unit and tiles that end in part of one) and through its work queue
(again and again, and on two streams at once), where two calls give the
same bits too.  Flash attention: float32 atol 2e-5 and bfloat16
atol 2e-2, as for paged attention.  In bfloat16 also every element within 2^-7 (M + |want|) + 1e-4
of the plain version on float32 q and k, M the same on |v|: with the scores
in float32, as the kernel takes them, the two differ only where each rounds
the weights and the output to bfloat16, so a fault in small outputs shows.
Two calls, and ``bq``/``bk``, change no bit.  bfloat16 runs on the
tensor-core tile (``attend_tile_mma.cuh``), float32 on the SIMT one.
Decode lanes (owners of one lane) of all three paged kernels run on the
split decode tile (``paged_decode_tile.cuh``): on the long-context cases
(owners of 1 to about 4000 keys, 1 to 16 splits) decode, chunked and
ragged give the same bits, each meets its plain version's tolerance and,
in bfloat16, the per-element limit that outputs under 0.25 moved by 8
ulps fail; a lane's bits do not depend on its neighbours in the launch,
two calls give the same bits (the splits combine in split order, not in
arrival order), and the ops add no host sync.
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
from repro_torch.kernels.flash_attention.ref import (bf16_share,
                                                     flash_attention_ref)
from repro_torch.kernels.gather_scatter import ops as gs
from repro_torch.kernels.gather_scatter import ref as gs_ref
from repro_torch.kernels import stream as stream_kernel
from repro_torch.kernels.stream import cases as stream_cases
from repro_torch.kernels.stream import ops as stream
from repro_torch.kernels.paged_attention.cases import (
    ARG_ORDER, CHUNKED_ARG_ORDER, CHUNKED_CASES, DECODE_ARG_ORDER,
    DECODE_CASES, LONG_DECODE, LONG_WIDTHS, SMALL, SMALL_CASES, chunked_case,
    decode_case, decode_lanes, ragged_case)

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
    c = ragged_case(np.random.default_rng(0), **dict(shape, **case))
    args = _args(c, dtype, card)
    before = api.paged_attention_ragged_op.launches
    got = api.paged_attention_ragged_op(*args)
    torch.cuda.synchronize()
    assert api.paged_attention_ragged_op.launches == before + 1
    want = api.paged_attention_ragged(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err
    if dtype == torch.bfloat16:
        assert api.ragged_bf16_share(got, *args) <= 1
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
LONG = [(LONG_WIDTHS[n], LONG_DECODE) for n in sorted(LONG_WIDTHS)]
DECODE += LONG
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
    if dtype == torch.bfloat16:
        assert api.chunked_bf16_share(got, *args) <= 1
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
    c = ragged_case(np.random.default_rng(0), **dict(shape, **case))
    q, pool, bl, br, bp, cu_q, cu_kv, ss = _args(c, dtype, card)
    ragged = api.paged_attention_ragged_op(q, pool, bl, br, bp, cu_q, cu_kv,
                                           ss)
    treq, tpos, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                               ss.shape[0])
    chunked = api.paged_attention_chunked_op(q, *fused_kv_views(pool), bl,
                                             br, bp, kvl, treq, tpos)
    torch.cuda.synchronize()
    assert torch.equal(ragged, chunked)


# The tensor-core tile's paging at smollm-360m's widths: 16-key pages (a
# 64-key stage spans 4), a shuffled BlockList, a prefill chunk in the middle
# of its sequence whose rows span three 128-row tiles, one from position 0,
# a two-lane owner, decode lanes, an empty entry and padding lanes.
FULL_LONG = dict(seqs=[(3, 1, 300), (0, 100, 450), (5, 1, 17), (1, 2, 40),
                       (2, 64, 64), (4, 0, 0), (8, 0, 0)],
                 num_lanes=200, num_entries=96, shuffle=True)
MMA_CASES = [(SMALL, SMALL_CASES["long_owner"]),
             (SMALL, SMALL_CASES["long_owner_g4"]), (FULL, FULL_CASE),
             (FULL, FULL_LONG)]


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("shape,case", MMA_CASES)
def test_bf16_tensor_core_tiles_match_plain_version(card, shape, case, hd):
    """bf16 ragged and chunked kernels, whose prefill owners run on the
    tensor-core tile, at every head dim: each against the plain version
    (atol 2e-2 and the per-element limit, which outputs under 0.25 moved
    by 8 ulps fail), and chunked at q_chunk 16 and 4, ragged and a second
    ragged call all the same bits."""
    c = ragged_case(np.random.default_rng(hd),
                    **dict(shape, **case, head_dim=hd))
    args = _args(c, torch.bfloat16, card)
    q, pool, bl, br, bp, cu_q, cu_kv, ss = args
    ragged = api.paged_attention_ragged_op(*args)
    treq, tpos, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                               ss.shape[0])
    cargs = [q, *fused_kv_views(pool), bl, br, bp, kvl, treq, tpos]
    outs = [api.paged_attention_chunked_op(*cargs, q_chunk=qc)
            for qc in (16, 4)]
    again = api.paged_attention_ragged_op(*args)
    torch.cuda.synchronize()
    want = api.paged_attention_ragged(*args)
    assert (ragged.float() - want.float()).abs().max().item() <= 2e-2
    assert api.ragged_bf16_share(ragged, *args) <= 1
    assert api.chunked_bf16_share(outs[0], *cargs) <= 1
    small = (ragged.float().abs() < 0.25).to(torch.int16)
    control = (ragged.view(torch.int16) + 8 * small).view(torch.bfloat16)
    assert api.ragged_bf16_share(control, *args) > 1
    for other in outs + [again]:
        assert torch.equal(ragged, other)
    assert torch.all(ragged[int(c["cu_q_lens"][-1]):] == 0)


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


def _decode_as_lanes(c, dtype, dev):
    """The decode case's arguments, and its requests as lanes of one lane
    each: the chunked kernel's and the ragged kernel's arguments
    (``cases.decode_lanes``)."""
    lanes = decode_lanes(c)
    return (_decode_args(c, dtype, dev), _chunked_args(lanes, dtype, dev),
            _args(lanes, dtype, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,case", [(FULL, FULL_DECODE)] + LONG)
def test_decode_kernel_equals_chunked_kernel_bitwise(card, shape, case,
                                                     dtype):
    """Decode == chunked == ragged on the same decode lanes, bit for bit:
    all three run them on the decode tile, cut into the same splits."""
    c = decode_case(np.random.default_rng(1), **shape, **case)
    args, chunked_args, ragged_args = _decode_as_lanes(c, dtype, card)
    decode = api.paged_attention_op(*args)
    chunked = api.paged_attention_chunked_op(*chunked_args)
    ragged = api.paged_attention_ragged_op(*ragged_args)
    torch.cuda.synchronize()
    assert torch.equal(decode, chunked)
    assert torch.equal(decode, ragged)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("shape,case", LONG)
def test_long_decode_lanes_match_plain_versions(card, shape, case, dtype,
                                                atol):
    """B3, and B1/B2 on the same decode lanes, against their plain versions
    on owners of 1 to 3999 keys (1 to 16 splits): f32 atol 2e-5; bf16 atol
    2e-2 and the per-element limit, which outputs under 0.25 moved by 8
    ulps fail; a second call gives the same bits; the empty request reads
    0."""
    c = decode_case(np.random.default_rng(2), **shape, **case)
    args, chunked_args, ragged_args = _decode_as_lanes(c, dtype, card)
    got = api.paged_attention_op(*args)
    outs = [api.paged_attention_chunked_op(*chunked_args),
            api.paged_attention_ragged_op(*ragged_args)]
    again = api.paged_attention_op(*args)
    torch.cuda.synchronize()
    for out, want in ((got, api.paged_attention_opt(*args)),
                      (outs[0], api.paged_attention_chunked(*chunked_args)),
                      (outs[1], api.paged_attention_ragged(*ragged_args))):
        assert (out.float() - want.float()).abs().max().item() <= atol
    if dtype == torch.bfloat16:
        assert api.chunked_bf16_share(got, *chunked_args) <= 1
        small = (got.float().abs() < 0.25).to(torch.int16)
        control = (got.view(torch.int16) + 8 * small).view(torch.bfloat16)
        assert api.chunked_bf16_share(control, *chunked_args) > 1
    assert torch.equal(got, again)
    assert torch.all(got[torch.from_numpy(c["seq_lens"] == 0).to(card)] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_lane_bits_do_not_depend_on_its_neighbours(card, dtype):
    """A 700-key decode lane (three splits) gives the same bits alone as
    beside a prefill chunk, another decode lane and padding lanes, in the
    ragged and in the chunked kernel."""
    c = ragged_case(np.random.default_rng(3), **FULL,
                    seqs=[(1, 64, 300), (0, 1, 700), (2, 1, 5), (4, 0, 0)],
                    num_lanes=80, num_entries=96, shuffle=True)
    args = _args(c, dtype, card)
    q, pool, bl, br, bp, cu_q, cu_kv, ss = args
    mixed = api.paged_attention_ragged_op(*args)
    lane = int(c["cu_q_lens"][1])                 # sequence 1's one lane
    alone = api.paged_attention_ragged_op(
        q[lane:lane + 1].contiguous(), pool, bl, br, bp,
        torch.tensor([0, 1], dtype=torch.int32, device=card),
        torch.tensor([0, 700], dtype=torch.int32, device=card),
        torch.tensor([0], dtype=torch.int32, device=card))
    treq, tpos, kvl = api.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                               ss.shape[0])
    pk, pv = fused_kv_views(pool)
    chunked = api.paged_attention_chunked_op(q, pk, pv, bl, br, bp, kvl,
                                             treq, tpos)
    chunked_alone = api.paged_attention_chunked_op(
        q[lane:lane + 1].contiguous(), pk, pv, bl, br, bp, kvl,
        treq[lane:lane + 1].contiguous(), tpos[lane:lane + 1].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(mixed[lane], alone[0])
    assert torch.equal(mixed, chunked)
    assert torch.equal(chunked_alone[0], alone[0])


def test_paged_ops_add_no_host_sync(card):
    """The decode, chunked and ragged ops launch without a host sync (the
    split workspace is sized from shapes, never from the key counts)."""
    c = decode_case(np.random.default_rng(4), **LONG_WIDTHS["smollm-360m"],
                    **LONG_DECODE)
    args, chunked_args, ragged_args = _decode_as_lanes(c, torch.bfloat16,
                                                       card)
    calls = ((api.paged_attention_op, args),
             (api.paged_attention_chunked_op, chunked_args),
             (api.paged_attention_ragged_op, ragged_args))
    want = [op(*a) for op, a in calls]          # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [op(*a) for op, a in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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


def _stream_args(op, a, b, scalar):
    """``op``'s arrays and scalar: ADD (a, b), SCALE (a, s), TRIAD (a, b,
    s)."""
    if op is stream.stream_add:
        return a, b
    return (a, scalar) if op is stream.stream_scale else (a, b, scalar)


def _stream_most(op, dtype):
    """The largest grid the STREAM kernel launches for ``op`` and
    ``dtype`` on this card (SMs x resident blocks per SM)."""
    p = stream_kernel.plan(stream.OPS.index(op), 128 * 1024, 8,
                           int(dtype == torch.bfloat16))
    return p["sms"] * p["blocks_per_sm"]


@pytest.mark.parametrize("edge", range(len(stream_cases.edge_shapes(1))))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op_index", range(3))
def test_stream_kernels_at_the_grid_edges_bitwise(card, op_index, dtype,
                                                   edge):
    """One tile of one row, fewer tiles than SMs, a tile count that is not
    a multiple of the grid, tiles larger than one 16 KiB unit and tiles
    that end in part of one: bitwise equal to the plain version, and two
    calls in a row give the same bits."""
    op = stream.OPS[op_index]
    what, rows, block_rows = stream_cases.edge_shapes(
        _stream_most(op, dtype))[edge]
    gen = torch.Generator(device=card)
    gen.manual_seed(edge)
    n = rows * stream.LANES
    a = torch.randn(n, generator=gen, device=card).to(dtype)
    b = torch.randn(n, generator=gen, device=card).to(dtype)
    args = _stream_args(op, a, b, 0.1)
    p = stream_kernel.plan(op_index, n, block_rows,
                           int(dtype == torch.bfloat16))
    assert p["grid"] == min(p["units"], p["sms"] * p["blocks_per_sm"])
    before = op.launches
    first = op(*args, block_rows)
    second = op(*args, block_rows)
    torch.cuda.synchronize()
    assert op.launches == before + 2, what
    assert torch.equal(_bits(first), _bits(op.plain(*args, block_rows))), what
    assert torch.equal(_bits(first), _bits(second)), what


def test_stream_grid_is_sized_to_the_card(card):
    """The grid fills the card whatever the tile height: at the reference's
    2^21 elements every block_rows of Fig 8 gets SMs x blocks per SM
    blocks, as many as its units allow."""
    n = 2 ** 21
    for block_rows in (8, 16, 64, 256, 1024):
        for op in range(3):
            p = stream_kernel.plan(op, n, block_rows, 0)
            most = p["sms"] * p["blocks_per_sm"]
            assert p["sms"] == torch.cuda.get_device_properties(
                0).multi_processor_count
            assert p["grid"] == min(most, p["units"])
            assert p["grid"] >= p["sms"]
            tile = block_rows * 512
            assert p["unit_bytes"] == (16384 // tile * tile if tile <= 16384
                                       else 16384)
            assert p["units"] * p["unit_bytes"] >= n * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_work_queue_across_calls_and_streams(card, dtype):
    """Past the first two rounds of units the blocks take units from a work
    queue: it resets after every launch (a prepared launch run again, as
    the timing harness runs it, gives the same bits), and calls on two
    streams at once take from two queues."""
    n = 2 ** 24
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    a, b, c = (torch.randn(n, generator=gen, device=card).to(dtype)
               for _ in range(3))
    code = int(dtype == torch.bfloat16)
    for op_index, op in enumerate(stream.OPS):
        assert stream_kernel.plan(op_index, n, 256, code)["queued"] > 0
        args, other = _stream_args(op, a, b, 3.0), _stream_args(op, c, a, 3.0)
        want = _bits(op.plain(*args, 256))
        launch = op.prepare(*args, 256)
        for _ in range(3):
            assert launch.fn(*launch.argv) == 0
            torch.cuda.synchronize()
            assert torch.equal(_bits(launch.out), want)
        s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
        torch.cuda.synchronize()
        with torch.cuda.stream(s1):
            got1 = op(*args, 256)
        with torch.cuda.stream(s2):
            got2 = op(*other, 256)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got1), want)
        assert torch.equal(_bits(got2), _bits(op.plain(*other, 256)))


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
# repeat, and rows that are not a multiple of 16 bytes (element loads);
# then rows of 3, 5 and 129 16-byte vectors (48, 80 and 2064 bytes: the
# masked tail of a lane group), N not a multiple of any batch of rows, and
# bfloat16 rows of a power of two of vectors.
GS_CASES = [(1000, 4, 3000, torch.float32), (1000, 16, 3000, torch.float32),
            (500, 64, 2000, torch.float32), (500, 512, 2000, torch.float32),
            (300, 3, 1000, torch.float32), (300, 8, 1000, torch.bfloat16),
            (300, 5, 1000, torch.bfloat16), (700, 12, 2501, torch.float32),
            (700, 20, 2501, torch.float32), (200, 516, 701, torch.float32),
            (700, 64, 1999, torch.bfloat16)]


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


@pytest.mark.parametrize("R,N,rows", [(16, 1_000_000, 16), (1, 5000, 1),
                                      (200_000, 2000, 16)])
def test_scatter_heavy_repeats_last_draw_wins(card, R, N, rows):
    """1 M draws over 16 rows, every draw on one row, and 2000 draws over
    16 rows of a table of R = 100 N rows, some of them as wrapped ids: the
    last draw of each row wins."""
    table, idx, src = _gs_inputs(card, R, 8, N, torch.float32, seed=1)
    idx = torch.randint(0, rows, (N,), device=card, dtype=torch.int32)
    idx[N // 2:N // 2 + 100] -= R                       # the same rows
    want = gs_ref.scatter_ref(table, idx, src)
    got = gs.vector_scatter(table, idx, src)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    last = {int(r) % R: n for n, r in enumerate(idx.tolist())}
    assert len(last) == rows
    for row, n in last.items():
        assert torch.equal(got[row], src[n])


def test_scatter_scratch_leaks_no_state(card):
    """Scatters in a row with other ids and a larger R each time (the last
    R is 67 N), each on a winner scratch that holds stale draws on entry:
    every entry N - 1, the largest draw, which atomicMax alone would keep,
    then random draws.  The scratch is the prepared launch's own, so the
    stale contents are certain."""
    for seed, (R, N) in enumerate(((1000, 3000), (5000, 4000),
                                   (200_000, 3000))):
        table, idx, src = _gs_inputs(card, R, 4, N, torch.float32,
                                     seed=10 + seed)
        for stale in (N - 1, None):
            want = gs_ref.scatter_ref(table, idx, src)
            got = table.clone()
            launch = gs.vector_scatter_.prepare(got, idx, src)
            assert launch.scratch.shape == (R,)
            if stale is None:
                launch.scratch.random_(0, N)
            else:
                launch.scratch.fill_(stale)
            assert launch.fn(*launch.argv) == 0
            torch.cuda.synchronize()
            assert torch.equal(_bits(got), _bits(want))
            idx = idx.flip(0)                       # other draws win


@pytest.mark.parametrize("R,D,N", [(50, 4, 1), (50, 4, 3), (50, 16, 5),
                                   (50, 512, 2), (50, 12, 7)])
def test_gather_scatter_fewer_draws_than_a_batch(card, R, D, N):
    """N smaller than one group of lanes' batch of rows."""
    gen = torch.Generator(device=card)
    gen.manual_seed(N)
    table = torch.randn((R, D), generator=gen, device=card)
    src = torch.randn((N, D), generator=gen, device=card)
    idx = torch.randint(-R, R, (N,), generator=gen, device=card,
                        dtype=torch.int32)
    got = gs.vector_gather(table, idx)
    scattered = gs.vector_scatter(table, idx, src)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(gs_ref.gather_ref(table, idx)))
    assert torch.equal(_bits(scattered),
                       _bits(gs_ref.scatter_ref(table, idx, src)))


@pytest.mark.parametrize("D", [4, 64])
def test_gather_scatter_table_offset_by_four_bytes(card, D):
    """Tables and source rows 4 bytes past a 16-byte boundary take the
    element path."""
    R, N = 300, 1000
    table, idx, src = _gs_inputs(card, R, D, N, torch.float32, seed=2)
    flat = torch.empty(R * D + 1, device=card)
    view = flat[1:].view(R, D)
    view.copy_(table)
    src_flat = torch.empty(N * D + 1, device=card)
    src_view = src_flat[1:].view(N, D)
    src_view.copy_(src)
    assert view.data_ptr() % 16 == 4 and src_view.data_ptr() % 16 == 4
    got = gs.vector_gather(view, idx)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(gs_ref.gather_ref(table, idx)))
    assert gs.vector_scatter_(view, idx, src_view) is view
    torch.cuda.synchronize()
    assert torch.equal(_bits(view),
                       _bits(gs_ref.scatter_ref(table, idx, src)))


def test_gather_scatter_all_ids_out_of_range(card):
    R, D, N = 100, 16, 777
    table, _, src = _gs_inputs(card, R, D, N, torch.float32, seed=3)
    idx = torch.randint(R, 2 ** 31 - 1, (N,), device=card,
                        dtype=torch.int32)
    idx[::2] = -R - 1 - idx[::2] % 1000
    got = gs.vector_gather(table, idx)
    scattered = gs.vector_scatter(table, idx, src)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got).all())
    assert torch.equal(_bits(scattered), _bits(table))


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
# smollm-360m's and Fig 17's head widths at a short sequence, then the
# bf16 tensor-core tile at every head dim, G = H / KV of 1, 3, 4 and 8
# and S of 1, 63, 65 and 1000 (a 64-key stage's tail, one position per
# tile row group, tiles of 128 / G positions).
FLASH_CASES = [(2, 128, 4, 2, 64, torch.float32),
               (1, 256, 6, 6, 64, torch.float32),
               (2, 64, 8, 2, 128, torch.float32),
               (1, 128, 4, 4, 64, torch.bfloat16),
               (1, 512, 15, 5, 64, torch.bfloat16),
               (2, 256, 32, 8, 128, torch.bfloat16),
               (1, 100, 4, 1, 16, torch.float32),
               (2, 1, 8, 8, 16, torch.bfloat16),
               (2, 63, 6, 2, 32, torch.bfloat16),
               (2, 65, 8, 2, 64, torch.bfloat16),
               (2, 1000, 8, 1, 128, torch.bfloat16),
               (2, 1000, 6, 2, 16, torch.bfloat16),
               (2, 65, 16, 2, 128, torch.bfloat16),
               (2, 63, 4, 4, 64, torch.bfloat16),
               (2, 1, 12, 4, 128, torch.bfloat16),
               (2, 1000, 15, 5, 64, torch.bfloat16),
               (2, 65, 4, 1, 32, torch.bfloat16)]


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
        assert bf16_share(got, q, k, v, causal) <= 1
    # a second call, and the TPU tiles, change no bit
    assert torch.equal(got, flash_attention(q, k, v, causal=causal, bq=S,
                                            bk=S))
    if S % 64 == 0:
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
