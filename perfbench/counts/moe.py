"""The least work of one MoE layer for the tokens it serves: the routed
work they need, not the full capacity the port runs.

Operations: the router (2 * d_model * experts a token) and the top-k
experts' SwiGLUs (2 * 3 * d_model * d_expert each).  Bytes, read once:
every expert's weights in the served type, the float32 router, and the
tokens' activations in and out.
"""
from __future__ import annotations

from typing import Tuple

from perfbench.counts import peaks


def layer_counts(d, tokens: int, elt: int = 2) -> Tuple[int, int]:
    D, F, E, K = d.d_model, d.d_ff, d.experts, d.top_k
    ops = tokens * (2 * D * E + K * 2 * 3 * D * F)
    nbytes = E * 3 * D * F * elt + D * E * 4 + 2 * tokens * D * elt
    return ops, nbytes


def step_bound_s(d, tokens: int) -> Tuple[float, str]:
    """Least seconds of a step's MoE layers, and the bound."""
    ops, nbytes = layer_counts(d, tokens)
    t, by = peaks.roofline_s(ops, nbytes)
    return d.layers * t, by
