"""The split-and-combine arithmetic of the paged kernels' decode tile
(``kernels/csrc/paged_decode_tile.cuh``, flash-decoding), modelled in plain
PyTorch on the CPU in float32 and held against the port's
``paged_attention_opt`` and the JAX reference on the decode cases of
``tests/test_torch_paged_decode.py``, at split sizes 16, 64 and the
kernels' ``SPLIT_KEYS`` (atol 1e-5).  The model follows the tile: each
request's pages in BlockList order, cut into splits of ``split`` keys, each
split an online softmax over stages of 64 keys (or of ``split`` when
smaller), then the splits rescaled by exp(m_s - m) and summed in split
order.  Also: the workspace sizing of ``attention_api`` agrees with the
header's ``kMaxSplitKeys``, and bounds the splits of every case; and the
decode cases as lanes of one lane (``cases.decode_lanes``, which the card
tests use to hold decode == chunked == ragged) give the same result
through the chunked and ragged plain versions."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention_api as japi
from repro_torch.core import attention_api as api
from repro_torch.core.paged_kv import fused_kv_views
from repro_torch.kernels.paged_attention.cases import (
    ARG_ORDER, CHUNKED_ARG_ORDER, DECODE_ARG_ORDER, DECODE_CASES, LONG_DECODE,
    LONG_WIDTHS, SMALL, decode_case, decode_lanes)

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "paged_decode_tile.cuh")
STAGE = 64          # the tile's keys per stage

# (NB, BS, KV, hd, H, B, lens): the reference's decode sweep, as in
# tests/test_torch_paged_decode.py, then a long owner at SMALL widths.
SWEEP = [(24, 8, 2, 64, 8, 3, [13, 8, 21]),
         (40, 16, 4, 128, 8, 4, [40, 1, 64, 17]),
         (16, 8, 6, 64, 6, 2, [5, 9]),
         (16, 8, 1, 64, 4, 2, [8, 16])]


def owner_pages(block_list, block_req, block_pos, b, kvl, BS, NB):
    """Request b's pages below kvl in BlockList order, as the list kernels
    compact them: (pool blocks clamped into [0, NB), block positions)."""
    hit = (block_req == b) & (block_pos.long() * BS < kvl)
    return block_list[hit].long().clamp(0, NB - 1), block_pos[hit].long()


def split_decode(q, pool_k, pool_v, block_list, block_req, block_pos,
                 seq_lens, split):
    """The decode tile's arithmetic in float32: per request and kv head,
    the keys of its compacted list cut into splits of ``split`` keys; each
    split's (m, l, acc) by the online update over stages; the splits
    combined in split order.  A request with no key reads 0."""
    B, H, HD = q.shape
    NB, BS, KV, _ = pool_k.shape
    G = H // KV
    scale = HD ** -0.5
    out = torch.zeros_like(q)
    for b in range(B):
        kvl = int(seq_lens[b])
        blk, pos = owner_pages(block_list, block_req, block_pos, b, kvl, BS,
                               NB)
        kp = (pos[:, None] * BS + torch.arange(BS)).reshape(-1)
        k = pool_k[blk].reshape(-1, KV, HD)           # keys in list order
        v = pool_v[blk].reshape(-1, KV, HD)
        qg = q[b].reshape(KV, G, HD)
        parts = []
        for s0 in range(0, max(len(kp), 1), split):
            m = torch.full((KV, G), api.NEG_INF)
            l = torch.zeros((KV, G))
            acc = torch.zeros((KV, G, HD))
            for t0 in range(s0, min(s0 + split, len(kp)), min(STAGE, split)):
                t1 = min(t0 + min(STAGE, split), s0 + split, len(kp))
                ok = kp[t0:t1] < kvl
                s = torch.einsum("kgd,tkd->kgt", qg, k[t0:t1]) * scale
                s = torch.where(ok, s, api.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "kgt,tkd->kgd", p, v[t0:t1])
                m = m_new
            parts.append((m, l, acc))
        m = torch.stack([p[0] for p in parts]).amax(0)
        o = torch.zeros((KV, G, HD))
        den = torch.zeros((KV, G))
        for m_s, l_s, acc_s in parts:                 # in split order
            f = torch.exp(m_s - m)
            o = o + f[..., None] * acc_s
            den = den + f * l_s
        out[b] = (o / den.clamp_min(1e-30)[..., None]).reshape(H, HD)
    return out


def _sweep(NB, BS, KV, hd, H, B, lens):
    """A decode case of the reference's sweep: a shuffled BlockList with
    padding entries, random float32 q and pools."""
    return decode_case(np.random.default_rng(NB + hd), num_heads=H,
                       num_kv=KV, head_dim=hd, block_size=BS, num_blocks=NB,
                       seq_lens=lens, num_entries=sum(-(-n // BS)
                                                      for n in lens) + 3,
                       shuffle=True)


CASES = ([_sweep(*case) for case in SWEEP]
         + [decode_case(np.random.default_rng(0), **SMALL, **DECODE_CASES[n])
            for n in sorted(DECODE_CASES)]
         + [decode_case(np.random.default_rng(1), **dict(SMALL,
                                                         num_blocks=200),
                        seq_lens=[1, 16, 17, 130, 600, 0],
                        num_entries=220, shuffle=True)])


@pytest.mark.parametrize("split", [16, 64, 128, api.SPLIT_KEYS,
                                   api.MAX_SPLIT_KEYS])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_and_combine_matches_opt_and_jax(case, split):
    c = CASES[case]
    t = [torch.from_numpy(c[k]) for k in DECODE_ARG_ORDER]
    got = split_decode(*t, split=split)
    np.testing.assert_allclose(got.numpy(),
                               api.paged_attention_opt(*t).numpy(),
                               atol=1e-5, rtol=0)
    want = japi.paged_attention_opt(*[jnp.asarray(c[k])
                                      for k in DECODE_ARG_ORDER])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert torch.all(got[torch.from_numpy(c["seq_lens"] == 0)] == 0)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_decode_lanes_give_the_decode_result(case):
    c = CASES[case]
    lanes = decode_lanes(c)
    ragged = [torch.from_numpy(lanes[k]) for k in ARG_ORDER]
    chunked = [ragged[0], *fused_kv_views(ragged[1]),
               *[torch.from_numpy(lanes[k]) for k in CHUNKED_ARG_ORDER]]
    want = api.paged_attention_opt(*[torch.from_numpy(c[k])
                                     for k in DECODE_ARG_ORDER])
    got = api.paged_attention_chunked(*chunked)
    assert torch.equal(got, api.paged_attention_ragged(*ragged))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_workspace_sizing_agrees_with_the_header():
    """``MAX_SPLIT_KEYS`` is the header's ``kMaxSplitKeys`` (which sizes the
    split's page list in shared memory), the default ``SPLIT_KEYS`` a
    multiple of the 64-key stage within it, and ``split_capacity`` bounds
    the splits of every case's owners (one per :data:`SPLIT_KEYS` keys, at
    least one each)."""
    text = HEADER.read_text()
    found = re.findall(r"constexpr int kMaxSplitKeys = (\d+);", text)
    assert found == [str(api.MAX_SPLIT_KEYS)]
    assert api.SPLIT_KEYS % STAGE == 0 and api.MAX_SPLIT_KEYS % STAGE == 0
    assert api.SPLIT_KEYS <= api.MAX_SPLIT_KEYS
    c = decode_case(np.random.default_rng(0), **LONG_WIDTHS["smollm-360m"],
                    **LONG_DECODE)
    for case in CASES + [c]:
        BS = case["pool_k"].shape[1]
        lens = case["seq_lens"]
        pages = [int(((case["block_req"] == b)
                      & (case["block_pos"].astype(np.int64) * BS < n)).sum())
                 for b, n in enumerate(lens)]
        splits = sum(max(1, -(-p * BS // api.SPLIT_KEYS)) for p in pages)
        assert splits <= api.split_capacity(len(lens),
                                            len(case["block_list"]), BS)
    # the long case's owners of kvl SPLIT_KEYS and SPLIT_KEYS + 1 hold one
    # and two splits, the one of 3999 keys ceil(4000 / SPLIT_KEYS)
    splits = {n: max(1, -(-16 * -(-n // 16) // api.SPLIT_KEYS))
              for n in LONG_DECODE["seq_lens"]}
    assert splits[api.SPLIT_KEYS] == 1 and splits[api.SPLIT_KEYS + 1] == 2
    assert splits[3999] == -(-4000 // api.SPLIT_KEYS) and splits[1] == 1
