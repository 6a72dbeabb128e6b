"""Token sampling with per-request knobs (port of
``repro.serving.sampling``): lanes with ``temperature <= 0`` take the
argmax; ``top_k <= 0`` / ``top_p >= 1`` disable the filters.  Random draws
come from an explicit ``torch.Generator``; they cannot replay
``jax.random``, so stochastic lanes agree with the reference only on the
filtered support (:func:`filter_logits`).  Nothing here reads a device
value on the host, so a step's sampling queues behind its forward without
waiting for it."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def filter_logits(lg: torch.Tensor, temp: torch.Tensor, kk: torch.Tensor,
                  pp: torch.Tensor) -> torch.Tensor:
    """Temperature/top-k/top-p filtered f32 logits, batched: lg (..., V),
    knobs (...).  Filtered-out entries are ``-inf``; top-p applies after
    top-k, keeping the smallest prefix of the survivors with mass >= p."""
    V = lg.shape[-1]
    scaled = lg.float() / torch.clamp_min(temp.float(), 1e-6)[..., None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kidx = (torch.clamp(kk, 1, V) - 1).long()[..., None]
    kth = torch.where(kk[..., None] > 0,
                      torch.gather(sorted_desc, -1, kidx), -torch.inf)
    masked = torch.where(scaled < kth, -torch.inf, scaled)
    sorted_m = torch.sort(masked, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_m, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < pp[..., None], dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_m, -1, torch.clamp(cutoff_idx, 0, V - 1))
    return torch.where(masked < cutoff, -torch.inf, masked)


def categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` (..., V) (``-inf`` = excluded):
    the argmax of ``logits - log E`` with E ~ Exp(1) (the Gumbel-max
    trick, the draw ``torch.multinomial`` makes for one sample, without
    its host-side check of the probabilities)."""
    e = torch.empty(logits.shape, dtype=torch.float32,
                    device=logits.device).exponential_(1, generator=gen)
    e.clamp_min_(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - e.log(), dim=-1)


def sample_batched(gen: torch.Generator, logits: torch.Tensor,
                   temperatures: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor) -> torch.Tensor:
    """Per-request sampling: logits (B, V) -> tokens (B,) int32."""
    tok = categorical(gen, filter_logits(logits, temperatures, top_ks,
                                         top_ps))
    return torch.where(temperatures <= 0, greedy(logits.float()),
                       tok.to(torch.int32))
