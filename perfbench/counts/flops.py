"""Model FLOPs of served lanes (the arithmetic of ``repro_torch.roofline.
model_flops``: 2 FLOPs per active parameter and token, plus attention,
counted here per lane).

A lane is one token computed in a step: ``(new, ctx)`` for a request is
``new`` lanes whose keys end at ``ctx`` (a prefill chunk, or one decode
lane with ``new == 1``).  Counted: the projections, the router and the
top-k experts a token is routed to (not the full capacity the port runs),
causal attention over each lane's real keys, and the output head for the
rows that sample a token.  ``d`` is ``harness.model.Dims``.
"""
from __future__ import annotations

from typing import Iterable, Tuple


def layer_params(d) -> int:
    """Active matrix parameters of one layer (norms are not products)."""
    q, kv = d.heads * d.head_dim, d.kv_heads * d.head_dim
    attn = d.d_model * (2 * q + 2 * kv)
    if d.moe:
        ffn = d.d_model * d.experts + d.top_k * 3 * d.d_model * d.d_ff
    else:
        ffn = 3 * d.d_model * d.d_ff
    return attn + ffn


def linear_flops_per_token(d) -> int:
    return 2 * d.layers * layer_params(d)


def head_flops(d) -> int:
    """The output head of one sampled row."""
    return 2 * d.vocab * d.d_model


def causal_keys(new: int, ctx: int) -> int:
    """(query, key) pairs of ``new`` lanes ending at ``ctx`` keys."""
    first = ctx - new + 1
    return new * first + new * (new - 1) // 2


def attention_flops(d, lanes: Iterable[Tuple[int, int]]) -> int:
    """2 for q.k and 2 for p.v per (query head, key), every layer."""
    keys = sum(causal_keys(n, c) for n, c in lanes)
    return 4 * d.heads * d.head_dim * d.layers * keys


def step_flops(d, lanes, sampled_rows: int) -> int:
    lanes = list(lanes)
    tokens = sum(n for n, _ in lanes)
    return (tokens * linear_flops_per_token(d) + attention_flops(d, lanes)
            + sampled_rows * head_flops(d))
