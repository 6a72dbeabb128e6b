"""The least work of one call of B1, the ragged paged-attention kernel
(the arithmetic of ``chip_smoke.py``'s ``ragged_bound``), for the lanes
one layer serves.

Bytes, each input read once and each output written once: every owner's
K and V rows below its key count, q of the real lanes, their outputs, and
the int32 page lists of those pages (block, owner and position) plus the
per-owner prefix sums.  Operations: 4 * head_dim per (query head, key)
pair.  ``lanes`` are ``(new, ctx)`` per owner, with distinct prompts, so
no page is shared.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from perfbench.counts import flops as flops_lib
from perfbench.counts import peaks


def call_counts(d, lanes: Iterable[Tuple[int, int]], block_size: int,
                elt: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one layer's call."""
    lanes = list(lanes)
    hd = d.head_dim
    rows = sum(c for _, c in lanes)
    tokens = sum(n for n, _ in lanes)
    pages = sum(-(-c // block_size) for _, c in lanes)
    nbytes = (rows * 2 * d.kv_heads * hd * elt
              + 2 * tokens * d.heads * hd * elt
              + 4 * (3 * pages + 3 * len(lanes) + 2))
    keys = sum(flops_lib.causal_keys(n, c) for n, c in lanes)
    return 4 * hd * d.heads * keys, nbytes


def step_bound_s(d, lanes, block_size: int) -> Tuple[float, str]:
    """Least seconds of a step's B1 calls (one a layer), and the bound."""
    ops, nbytes = call_counts(d, lanes, block_size)
    t, by = peaks.roofline_s(ops, nbytes)
    return d.layers * t, by
