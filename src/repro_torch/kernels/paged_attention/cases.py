"""Seeded numpy inputs for ragged paged attention, shared by the tests and
``chip_smoke.py`` so the CPU parity tests and the card's kernel checks run
the same kinds of cases."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


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
# (slot, 0, kvl) an empty entry in the middle.
SMALL = dict(num_heads=6, num_kv=2, head_dim=16, block_size=4, num_blocks=24)
SMALL_CASES = {
    "mixed": dict(seqs=[(2, 1, 9), (0, 5, 5), (3, 1, 13), (1, 3, 7),
                        (5, 0, 0), (5, 0, 0)],
                  num_lanes=16, num_entries=20),
    "empty_middle": dict(seqs=[(1, 4, 6), (0, 0, 6), (2, 1, 3), (4, 0, 0)],
                         num_lanes=8, num_entries=12, shuffle=True),
    "decode_only": dict(seqs=[(0, 1, 11), (1, 1, 2), (2, 1, 16), (3, 1, 1)],
                        num_lanes=8, num_entries=16),
}

ARG_ORDER = ("q", "kv_pool", "block_list", "block_req", "block_pos",
             "cu_q_lens", "cu_kv_lens", "seq_slot")
