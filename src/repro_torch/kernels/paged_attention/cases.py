"""Seeded numpy inputs for ragged paged attention, shared by the tests and
``chip_smoke.py`` so the CPU parity tests and the card's kernel checks run
the same kinds of cases."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.attention_api import SPLIT_KEYS


def ragged_case(rng: np.random.Generator, *, num_heads: int, num_kv: int,
                head_dim: int, block_size: int, num_blocks: int,
                seqs: Sequence[Tuple[int, int, int]], num_lanes: int,
                num_entries: int, shuffle: bool = False
                ) -> Dict[str, np.ndarray]:
    """One ragged-attention input set, float32 values.

    ``seqs`` lists ``(slot, nq, kvl)`` per sequence entry: its engine slot
    (``>= len(seqs)`` marks an entry whose write is dropped), its query
    lanes and its valid keys after this step.  Lanes past the last sequence
    are padding; BlockList entries past the sequences' pages are padding
    (``block_req == len(seqs)``).  ``shuffle`` permutes the BlockList.
    """
    S = len(seqs)
    H, KV, HD, BS = num_heads, num_kv, head_dim, block_size
    pages = rng.permutation(num_blocks)
    bl, br, bp = [], [], []
    used = 0
    for slot, _, kvl in seqs:
        if slot >= S:
            continue
        n = -(-kvl // BS)
        bl += list(pages[used:used + n])
        br += [slot] * n
        bp += list(range(n))
        used += n
    if len(bl) > num_entries or used > num_blocks:
        raise ValueError("case needs more BlockList entries or pool blocks")
    pad = num_entries - len(bl)
    bl, br, bp = (np.asarray(bl + [0] * pad, np.int32),
                  np.asarray(br + [S] * pad, np.int32),
                  np.asarray(bp + [0] * pad, np.int32))
    if shuffle:
        perm = rng.permutation(num_entries)
        bl, br, bp = bl[perm], br[perm], bp[perm]
    nq = np.asarray([s[1] for s in seqs], np.int64)
    kvl = np.asarray([s[2] for s in seqs], np.int64)
    if nq.sum() > num_lanes:
        raise ValueError("case needs more lanes")
    cu_q = np.zeros((S + 1,), np.int32)
    cu_kv = np.zeros((S + 1,), np.int32)
    cu_q[1:] = np.cumsum(nq)
    cu_kv[1:] = np.cumsum(kvl)
    return {
        "q": rng.standard_normal((num_lanes, H, HD)).astype(np.float32),
        "kv_pool": rng.standard_normal(
            (num_blocks, BS, 2 * KV, HD)).astype(np.float32),
        "block_list": bl, "block_req": br, "block_pos": bp,
        "cu_q_lens": cu_q, "cu_kv_lens": cu_kv,
        "seq_slot": np.asarray([s[0] for s in seqs], np.int32),
    }


# Small cases, head_dim 16, G = 3 (6 q heads over 2 kv heads), block size 4:
# (slot, nq, kvl) per sequence entry.  Slots are out of order; kv lengths
# are not multiples of the block size; prefill chunks sit beside decode
# lanes (nq = 1); (slot >= S, 0, 0) entries are empty padding entries and
# (slot, 0, kvl) an empty entry in the middle.  A case may override SMALL's
# widths: build it with ``ragged_case(rng, **dict(SMALL, **case))``.
#
# The long_owner cases hold a prefill chunk in the middle of its sequence
# (nq 50 of kvl 70 at G = 3; 40 of 60 and 33 of 33 at G = 4, with 8 q
# heads over 2 kv heads) whose rows span more than one 128-row tile of the
# card's tensor-core tile, beside decode lanes, a two-lane owner and a
# shuffled BlockList.  The verify case is a speculative verify step as the
# reference renders it: owners of 1 + k = 4 lanes (the last token and
# three drafts) that start in the middle of a block, cross into the next
# one or start at position 0, beside a decode lane.
SMALL = dict(num_heads=6, num_kv=2, head_dim=16, block_size=4, num_blocks=24)
SMALL_CASES = {
    "mixed": dict(seqs=[(2, 1, 9), (0, 5, 5), (3, 1, 13), (1, 3, 7),
                        (5, 0, 0), (5, 0, 0)],
                  num_lanes=16, num_entries=20),
    "empty_middle": dict(seqs=[(1, 4, 6), (0, 0, 6), (2, 1, 3), (4, 0, 0)],
                         num_lanes=8, num_entries=12, shuffle=True),
    "decode_only": dict(seqs=[(0, 1, 11), (1, 1, 2), (2, 1, 16), (3, 1, 1)],
                        num_lanes=8, num_entries=16),
    "long_owner": dict(seqs=[(1, 1, 9), (0, 50, 70), (3, 1, 13), (2, 2, 6),
                             (5, 0, 0)],
                       num_lanes=60, num_entries=32, num_blocks=32,
                       shuffle=True),
    "long_owner_g4": dict(seqs=[(0, 40, 60), (2, 1, 11), (1, 33, 33),
                                (4, 0, 0)],
                          num_lanes=80, num_entries=32, num_blocks=32,
                          shuffle=True, num_heads=8),
    "verify": dict(seqs=[(0, 4, 11), (2, 4, 6), (1, 1, 9), (3, 4, 4),
                         (5, 0, 0)],
                   num_lanes=16, num_entries=16, shuffle=True),
}

ARG_ORDER = ("q", "kv_pool", "block_list", "block_req", "block_pos",
             "cu_q_lens", "cu_kv_lens", "seq_slot")


def _block_list(rng, pages, kvls, block_size, num_entries, shuffle):
    """BlockList arrays of owners ``0..len(kvls)-1`` holding ``kvls`` keys,
    pages drawn from ``pages`` in order; padding entries carry owner
    ``len(kvls)``."""
    B = len(kvls)
    bl, br, bp = [], [], []
    for b, kvl in enumerate(kvls):
        n = -(-kvl // block_size)
        bl += list(pages[len(bl):len(bl) + n])
        br += [b] * n
        bp += list(range(n))
    if len(bl) > num_entries or len(bl) > len(pages):
        raise ValueError("case needs more BlockList entries or pool blocks")
    pad = num_entries - len(bl)
    bl, br, bp = (np.asarray(bl + [0] * pad, np.int32),
                  np.asarray(br + [B] * pad, np.int32),
                  np.asarray(bp + [0] * pad, np.int32))
    if shuffle:
        perm = rng.permutation(num_entries)
        bl, br, bp = bl[perm], br[perm], bp[perm]
    return bl, br, bp


def chunked_case(rng: np.random.Generator, *, num_heads: int, num_kv: int,
                 head_dim: int, block_size: int, num_blocks: int,
                 kv_lens: Sequence[int], lanes: Sequence[Tuple[int, int]],
                 num_entries: int, shuffle: bool = False
                 ) -> Dict[str, np.ndarray]:
    """One chunked-attention input set over a fused pool, float32 values.

    ``kv_lens`` gives each slot's keys (0: an empty request); ``lanes``
    gives ``(owner, position)`` per lane, owners in any order (``>=
    len(kv_lens)``: a padding lane).  The split pools are the fused pool's
    :func:`fused_kv_views`.
    """
    H, KV, HD, BS = num_heads, num_kv, head_dim, block_size
    bl, br, bp = _block_list(rng, rng.permutation(num_blocks), kv_lens, BS,
                             num_entries, shuffle)
    return {
        "q": rng.standard_normal((len(lanes), H, HD)).astype(np.float32),
        "kv_pool": rng.standard_normal(
            (num_blocks, BS, 2 * KV, HD)).astype(np.float32),
        "block_list": bl, "block_req": br, "block_pos": bp,
        "kv_lens": np.asarray(kv_lens, np.int32),
        "token_req": np.asarray([o for o, _ in lanes], np.int32),
        "token_pos": np.asarray([p for _, p in lanes], np.int32),
    }


def decode_case(rng: np.random.Generator, *, num_heads: int, num_kv: int,
                head_dim: int, block_size: int, num_blocks: int,
                seq_lens: Sequence[int], num_entries: int,
                shuffle: bool = False) -> Dict[str, np.ndarray]:
    """One decode-shape input set, float32 values: q (B, H, HD), split
    pools (NB, BS, KV, HD), a BlockList sorted by request (unless
    ``shuffle``) with padding entries, seq_lens (B,).  A request of length
    0 has no entry."""
    H, KV, HD, BS = num_heads, num_kv, head_dim, block_size
    bl, br, bp = _block_list(rng, rng.permutation(num_blocks), seq_lens, BS,
                             num_entries, shuffle)
    shape = (num_blocks, BS, KV, HD)
    return {
        "q": rng.standard_normal((len(seq_lens), H, HD)).astype(np.float32),
        "pool_k": rng.standard_normal(shape).astype(np.float32),
        "pool_v": rng.standard_normal(shape).astype(np.float32),
        "block_list": bl, "block_req": br, "block_pos": bp,
        "seq_lens": np.asarray(seq_lens, np.int32),
    }


def decode_lanes(case: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A decode case's requests as lanes of one lane each, for the chunked
    and ragged kernels: ``token_req`` = ``seq_slot`` = arange(B),
    ``token_pos`` = seq_lens - 1, ``kv_lens`` = seq_lens, ``cu_q_lens`` =
    arange(B + 1), ``cu_kv_lens`` the lengths' prefix sums, and
    ``kv_pool`` the fused pool of ``pool_k`` and ``pool_v``, beside the
    case's own arrays."""
    lens = case["seq_lens"]
    ids = np.arange(len(lens), dtype=np.int32)
    cu_kv = np.zeros((len(lens) + 1,), np.int32)
    cu_kv[1:] = np.cumsum(lens)
    k, v = case["pool_k"], case["pool_v"]
    fused = np.stack([k, v], axis=-2).reshape(*k.shape[:2], -1, k.shape[3])
    return dict(case, kv_lens=lens, token_req=ids, token_pos=lens - 1,
                cu_q_lens=np.arange(len(lens) + 1, dtype=np.int32),
                cu_kv_lens=cu_kv, seq_slot=ids, kv_pool=fused)


# Chunked lanes at SMALL widths: owners interleaved within a tile (0 2 0 2),
# an empty request (slot 1, no keys), positions inside and past the chunk,
# padding lanes (owner 4) in the middle and at the end.
CHUNKED_CASES = {
    "interleaved": dict(kv_lens=[9, 0, 13, 6],
                        lanes=[(0, 7), (2, 12), (0, 8), (2, 11), (3, 5),
                               (1, 0), (4, 0), (3, 2), (0, 3), (4, 0),
                               (4, 0)],
                        num_entries=14, shuffle=True),
    "runs": dict(kv_lens=[5, 16, 3],
                 lanes=[(1, p) for p in range(4, 16)] + [(0, 4), (2, 2)]
                 + [(3, 0)] * 2,
                 num_entries=10),
}
CHUNKED_ARG_ORDER = ("block_list", "block_req", "block_pos", "kv_lens",
                     "token_req", "token_pos")

# Decode requests at SMALL widths: one of length 0 (no entry, reads 0),
# lengths off and on block boundaries, padding entries.
DECODE_CASES = {
    "sorted": dict(seq_lens=[9, 4, 0, 13, 1], num_entries=12),
    "shuffled": dict(seq_lens=[16, 3, 7], num_entries=9, shuffle=True),
}
DECODE_ARG_ORDER = ("q", "pool_k", "pool_v", "block_list", "block_req",
                    "block_pos", "seq_lens")

# Long-context decode requests for the kernels' decode tile, which cuts an
# owner's keys into splits of SPLIT_KEYS (256): kvl 1, SPLIT_KEYS (one
# split), SPLIT_KEYS + 1 (two, the second holding one valid key), 700
# (three), 129, an empty request and 3999 (16 splits), a shuffled, padded
# BlockList; at smollm-360m's widths (G 3, hd 64) and Fig 17's (G 4, hd
# 128).
LONG_DECODE = dict(seq_lens=[1, SPLIT_KEYS, SPLIT_KEYS + 1, 700, 129, 0,
                             3999],
                   num_entries=400, shuffle=True)
LONG_WIDTHS = {
    "smollm-360m": dict(num_heads=15, num_kv=5, head_dim=64, block_size=16,
                        num_blocks=360),
    "fig17": dict(num_heads=32, num_kv=8, head_dim=128, block_size=16,
                  num_blocks=360),
}
