"""Token sampling with per-request knobs (port of
``repro.serving.sampling``): lanes with ``temperature <= 0`` take the
argmax; ``top_k <= 0`` / ``top_p >= 1`` disable the filters.  Random draws
come from an explicit ``torch.Generator``; they cannot replay
``jax.random``, so stochastic lanes agree with the reference only on the
filtered support (:func:`filter_logits`)."""
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


def sample_batched(gen: torch.Generator, logits: torch.Tensor,
                   temperatures: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor) -> torch.Tensor:
    """Per-request sampling: logits (B, V) -> tokens (B,) int32."""
    masked = filter_logits(logits, temperatures, top_ks, top_ps)
    tok = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                            generator=gen)[:, 0]
    return torch.where(temperatures <= 0, greedy(logits.float()),
                       tok.to(torch.int32))
