"""Losses (port of ``repro.training.losses``).

``softmax_cross_entropy`` is the float32 log-sum-exp minus the target
logit.  The reference picks the target logit with an iota-select-reduce
(vocab-parallel safe); one ``gather`` gives the same value here, and a
target outside ``[0, V)`` reads 0 as the select does.
"""
from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """logits (..., V) any dtype; targets (...) int -> nll (...) f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    V = logits.shape[-1]
    t = targets.long()
    valid = (t >= 0) & (t < V)
    tgt = torch.gather(logits, -1, t.clamp(0, V - 1)[..., None])[..., 0]
    return lse - torch.where(valid, tgt, 0.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    loss_mask=None) -> torch.Tensor:
    """Next-token CE over (B, S, V) logits vs (B, S) tokens."""
    nll = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
    if loss_mask is not None:
        m = loss_mask[:, 1:].float()
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)
