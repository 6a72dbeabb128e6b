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

Expert parallelism (``tp=``, a ``TensorParallel`` of the mesh): the
rules put ``E / model`` experts on each rank (``w_gate``/``w_up``/
``w_down`` split on their expert dim; ``shard`` is the reference's layout
hint, and on a mesh the rules decide), and dispatch runs per token group,
the groups (``groups``, a multiple of the data shards) split over the data
axes, so each group's top-C runs on the ranks that hold its tokens.  x is
this rank's batch shard, whole over ``model`` (Megatron's replicated
activations), so:

* when a data row's groups divide over ``model``, rank m routes its share
  of them, each expert's C tokens go to the expert's rank by all-to-all,
  the outputs return the same way, the combine runs on the routing rank
  and the groups are gathered back over ``model``;
* otherwise (one group a data row: the (2, 2) training mesh, and the
  serving mesh, data 1, at full capacity) every rank of the row routes
  its groups, already holds every token its experts take, runs its
  experts on them and one float32 SUM over ``model`` combines the ranks'
  partial outputs.

The aux loss is the reference's over all T tokens: each rank's expert
counts and gate sums, summed over the axes whose ranks routed other
tokens.  The combine keeps the order above in both layouts.
:data:`dispatch_counts` counts the calls that took each layout.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.layers.mlp import mlp_apply_tp, swiglu, swiglu_init
from repro_torch.perf import spans

# expert-parallel calls by layout (module docstring), plain integers a
# caller may reset and read, as a kernel wrapper's ``launches``
dispatch_counts = {"all_to_all": 0, "sum": 0}


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
              data_axes=("pod", "data"), expert_axis: str = "model",
              shard: bool = False, full_capacity: bool = False,
              groups: int = 1, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss ()), capacity-dropped top-k
    routing.  ``full_capacity`` sets C = T per group, so no token is
    dropped (the decode and serving mode).  ``groups``: dispatch runs
    independently per token group, as in the reference (the largest count
    at most ``groups`` that divides the tokens).  ``tp``: expert
    parallelism over ``expert_axis`` on its mesh (module docstring), x this
    rank's batch shard and params its shards; the data axes are those
    scoped by ``activation_sharding``, else ``data_axes``.  The call is
    the ``model.moe`` span (:mod:`repro_torch.perf.spans`)."""
    with spans.span("model.moe"):
        return _moe_apply(params, x, m, data_axes, expert_axis,
                          full_capacity, groups, tp)


def _moe_apply(params, x, m, data_axes, expert_axis, full_capacity, groups,
               tp):
    if tp is not None:
        if expert_axis != tp.axis:
            raise ValueError(f"expert axis {expert_axis!r}: the mesh's "
                             f"tensor-parallel axis is {tp.axis!r}")
        return _moe_mesh(params, x, m, tp, _resolve_axes(data_axes),
                         full_capacity, groups)
    B, S, D = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    G = _num_groups(groups, T)
    Tg = T // G
    xg = x.reshape(G, Tg, D)
    gates_all, topk_idx, gate_ec, token_idx = _route(
        xg, params["router"], m, full_capacity)
    out_ec = _experts(params, _dispatch(xg, token_idx), x.dtype)
    out = _combine(out_ec * gate_ec[..., None].to(out_ec.dtype), token_idx,
                   Tg)
    if "shared" in params:
        out = out + swiglu(params["shared"], xg)
    return out.reshape(B, S, D), _aux_loss(gates_all.reshape(T, E),
                                           topk_idx.reshape(T, K), E)


def _resolve_axes(data_axes):
    """The activation_sharding scope's axes when set (the reference's
    rule), else ``data_axes``."""
    from repro_torch.distributed.act_sharding import current_data_axes
    scoped = current_data_axes()
    return tuple(scoped if scoped is not None else data_axes)


def _num_groups(groups: int, T: int) -> int:
    G = max(1, min(groups, T))
    while T % G:
        G -= 1
    return G


def _route(xg, router, m: MoEConfig, full_capacity: bool):
    """Gates (G, Tg, E) f32, each token's top-k experts (G, Tg, K), and
    each expert's top-C tokens (G, E, C) with their gates."""
    E, K = m.num_experts, m.top_k
    Tg = xg.shape[1]
    logits = torch.matmul(xg.float(), router.float())            # (G,Tg,E)
    gates_all = torch.softmax(logits, dim=-1)
    topk_val, topk_idx = _top_k(gates_all, K)                    # (G,Tg,K)
    topk_val = topk_val / topk_val.sum(-1, keepdim=True).clamp_min(1e-9)
    sel = torch.zeros_like(gates_all).scatter(-1, topk_idx, topk_val)
    C = Tg if full_capacity else min(
        max(1, int(Tg * K / E * m.capacity_factor)), Tg)
    gate_ec, token_idx = _top_k(sel.transpose(1, 2), C)          # (G,E,C)
    return gates_all, topk_idx, gate_ec, token_idx


def _dispatch(xg, token_idx):
    """The tokens of each (group, expert, slot): (G, E', C, D)."""
    G, E, C = token_idx.shape
    D = xg.shape[-1]
    return torch.gather(
        xg, 1, token_idx.reshape(G, E * C, 1).expand(G, E * C, D)
    ).reshape(G, E, C, D)


def _experts(params, dispatched, dtype):
    """A SwiGLU per expert over (G, E', C, D), E' the experts ``params``
    holds (batched ``torch.matmul`` over them)."""
    g = torch.matmul(dispatched, params["w_gate"])               # (G,E,C,F)
    u = torch.matmul(dispatched, params["w_up"])
    h = F.silu(g.float()).to(dtype) * u
    return torch.matmul(h, params["w_down"])                     # (G,E,C,D)


def _combine(out_ec, token_idx, Tg: int):
    """Back to token order: expert e's C distinct tokens into row e, then
    the rows summed (no atomics); dropped tokens stay 0."""
    G, E, C, D = out_ec.shape
    rows = torch.zeros((G, E, Tg, D), dtype=out_ec.dtype,
                       device=out_ec.device)
    rows = rows.scatter(2, token_idx[..., None].expand(G, E, C, D), out_ec)
    return rows.sum(dim=1)


def _moe_mesh(params, x, m: MoEConfig, tp, data_axes, full_capacity: bool,
              groups: int):
    from repro_torch.distributed import collectives

    mesh = tp.mesh
    B, S, D = x.shape
    E, K = m.num_experts, m.top_k
    dp = tuple(a for a in data_axes
               if a in mesh.axis_names and mesh.size(a) > 1)
    shards = 1
    for a in dp:
        shards *= mesh.size(a)
    T = B * S * shards                          # the global token count
    G = _num_groups(groups, T)
    if G % shards:
        raise ValueError(f"{G} MoE groups over {shards} data shards: a "
                         "group must not span data ranks (moe_groups = a "
                         "multiple of the data shards)")
    Gl, Tg = G // shards, T // G
    xg = x.reshape(Gl, Tg, D)
    split = tp.split("layers", "moe", "w_gate")
    M = tp.size if split else 1
    if split and Gl % M == 0:                   # each rank routes Gl / M
        dispatch_counts["all_to_all"] += 1
        Gr = Gl // M
        r = tp.rank
        xr = tp.enter(xg)[r * Gr:(r + 1) * Gr]
        gates_all, topk_idx, gate_ec, token_idx = _route(
            xr, tp.enter(params["router"]), m, full_capacity)
        C = token_idx.shape[-1]
        send = _dispatch(xr, token_idx).reshape(Gr, M, E // M, C, D)
        recv = collectives.all_to_all_f(
            send.transpose(0, 1).reshape(M * Gr, E // M, C, D), mesh,
            tp.axis)                            # (Gl, E / M, C, D)
        back = collectives.all_to_all_f(
            _experts(params, recv, x.dtype), mesh, tp.axis)
        out_ec = back.reshape(M, Gr, E // M, C, D).transpose(0, 1).reshape(
            Gr, E, C, D)
        out = _combine(out_ec * gate_ec[..., None].to(out_ec.dtype),
                       token_idx, Tg)
        out = collectives.gather_replicated(out, mesh, tp.axis, dim=0)
        routed_axes = dp + (tp.axis,)
    else:                                       # every rank routes them all
        dispatch_counts["sum"] += 1
        gates_all, topk_idx, gate_ec, token_idx = _route(
            xg, params["router"], m, full_capacity)
        lo, hi = tp.bounds(E) if split else (0, E)
        mine = token_idx[:, lo:hi]
        xd = tp.enter(xg) if split else xg
        out_ec = _experts(params, _dispatch(xd, mine), x.dtype)
        gate = tp.enter(gate_ec) if split else gate_ec
        out = _combine(out_ec * gate[:, lo:hi, :, None].to(out_ec.dtype),
                       mine, Tg)
        if split:
            out = tp.psum(out)
        routed_axes = dp
    if "shared" in params:
        if tp.split("layers", "moe", "shared", "w_gate"):
            out = out + mlp_apply_tp(params["shared"], xg, "swiglu", tp)
        else:
            out = out + swiglu(params["shared"], xg)
    # the reference's aux loss over all T tokens
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, topk_idx.reshape(-1), torch.ones(
        (topk_idx.numel(),), dtype=torch.float32, device=x.device))
    gsum = gates_all.reshape(-1, E).sum(0)
    counts = collectives.reduce_from(counts, mesh, routed_axes)
    gsum = collectives.reduce_from(gsum, mesh, routed_axes)
    aux = E * torch.sum(counts / (T * K) * (gsum / T))
    return out.reshape(B, S, D), aux


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
