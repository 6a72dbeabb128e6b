"""Token-choice top-k mixture of experts with capacity-based dispatch (port
of ``repro.layers.moe``).

The reference's function, step by step and in both modes:

* router logits and softmax in float32, the top-k gates of each token,
  renormalised over the chosen experts;
* each expert keeps its top-C tokens by gate (C from ``capacity_factor``,
  or C = T at ``full_capacity``, the serving mode, where no token can be
  dropped), so an expert drops the same tokens as the reference's;
* the kept tokens are gathered, run through a SwiGLU per expert (batched
  ``torch.matmul`` over the experts: the reference leaves these products to
  XLA, outside any kernel of its own), scaled by their gates and combined
  back in token order; a dropped token gets 0 (the residual keeps x);
* the shared expert, where the config has one; the switch-style
  load-balance loss.

Ties: ``lax.top_k`` takes the lower index first among equal values, and so
does :func:`_top_k` (a stable descending sort), where ``torch.topk``'s
order among ties is unspecified.  The combine adds nothing with atomics:
each expert's C tokens are distinct, so its outputs are scattered into
their own row of an (experts, tokens) buffer and the rows are summed, the
same sum in the same order on every call (on the card ``index_add_``
would sum a token's expert outputs in an order that changes from run to
run, and bf16 greedy streams with it).  At full capacity most gates are
exact zeros, which add exactly 0.

The reference's mesh arguments (``shard``, ``data_axes``, ``expert_axis``)
wait for expert parallelism (ROADMAP A10's training half); until then a
MoE config does not serve on a mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.layers.mlp import swiglu, swiglu_init


def moe_init(gen: torch.Generator, d_model: int, m: MoEConfig,
             dtype=torch.float32, device="cpu") -> Dict:
    """Random parameters with the reference's names and layouts: router
    (D, E) float32; w_gate, w_up (E, D, F) and w_down (E, F, D) in
    ``dtype``; ``shared`` a SwiGLU of ``d_shared_expert`` where set."""
    E, F_ = m.num_experts, m.d_expert
    s = d_model ** -0.5

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * scale

    p = {
        "router": normal((d_model, E), s),
        "w_gate": normal((E, d_model, F_), s).to(dtype),
        "w_up": normal((E, d_model, F_), s).to(dtype),
        "w_down": normal((E, F_, d_model), F_ ** -0.5).to(dtype),
    }
    if m.d_shared_expert:
        p["shared"] = swiglu_init(gen, d_model, m.d_shared_expert, dtype,
                                  device)
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, the
    lower index first among ties (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x: torch.Tensor, m: MoEConfig, *,
              full_capacity: bool = False,
              groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss ()), capacity-dropped top-k
    routing.  ``full_capacity`` sets C = T per group, so no token is
    dropped (the decode and serving mode).  ``groups``: dispatch runs
    independently per token group, as in the reference (the largest count
    at most ``groups`` that divides the tokens)."""
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    G = max(1, min(groups, T))
    while T % G:
        G -= 1
    Tg = T // G
    xg = x.reshape(G, Tg, D)

    logits = torch.matmul(xg.float(), params["router"].float())  # (G,Tg,E)
    gates_all = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = _top_k(gates_all, K)                    # (G,Tg,K)
    topk_val = topk_val / topk_val.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = torch.zeros_like(gates_all).scatter(-1, topk_idx, topk_val)

    C = Tg if full_capacity else min(
        max(1, int(Tg * K / E * m.capacity_factor)), Tg)
    gate_ec, token_idx = _top_k(sel.transpose(1, 2), C)          # (G,E,C)
    dispatched = torch.gather(
        xg, 1, token_idx.reshape(G, E * C, 1).expand(G, E * C, D))
    dispatched = dispatched.reshape(G, E, C, D)

    g = torch.matmul(dispatched, params["w_gate"])               # (G,E,C,F)
    u = torch.matmul(dispatched, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    out_ec = torch.matmul(h, params["w_down"])                   # (G,E,C,D)
    out_ec = out_ec * gate_ec[..., None].to(out_ec.dtype)

    # back to token order: expert e's C distinct tokens into row e, then the
    # rows summed (no atomics); dropped tokens stay 0
    rows = torch.zeros((G, E, Tg, D), dtype=out_ec.dtype, device=x.device)
    rows.scatter_(2, token_idx[..., None].expand(G, E, C, D), out_ec)
    out = rows.sum(dim=1)
    if "shared" in params:
        out = out + swiglu(params["shared"], xg)
    return out.reshape(B, S, D), _aux_loss(gates_all.reshape(T, E),
                                           topk_idx.reshape(T, K), E)


def _aux_loss(gates_all: torch.Tensor, topk_idx: torch.Tensor,
              E: int) -> torch.Tensor:
    """Switch-style load-balance loss (mean over tokens).  The counts are
    exact integers, so their sum order does not matter."""
    T, K = topk_idx.shape
    counts = torch.zeros((E,), dtype=torch.float32,
                         device=gates_all.device).scatter_add_(
        0, topk_idx.reshape(-1), torch.ones((T * K,), dtype=torch.float32,
                                            device=gates_all.device))
    frac_tokens = counts / (T * K)
    frac_gates = gates_all.mean(0)
    return E * torch.sum(frac_tokens * frac_gates)
