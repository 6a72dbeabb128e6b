"""Batched verify + distribution-preserving rejection-accept (port of
``repro.serving.spec.verify``).

The engine lays a drafted request's lanes out as ``[last_token, d_1, ...,
d_k]`` and ``decode_tokens_paged`` returns a logit row per lane: row ``j``
is the target distribution of the token after lane ``j``, the one draft
``d_{j+1}`` claims; row ``k`` is the bonus row after a full accept.

* Greedy lane (``temperature <= 0``): accept ``d_j`` iff it is the argmax
  of row ``j``'s raw f32 logits (``torch.argmax`` takes the first index of
  a tie, as ``jnp.argmax`` does); the token after the accepted prefix is
  that row's argmax.  Greedy streams equal the draftless engine's.
* Stochastic lane: accept ``d_j`` with probability ``p_j(d_j)`` (the
  ``min(1, p/q)`` rule for a point-mass draft); at the first rejection emit
  a draw from ``p_j`` with ``d_j`` removed, after a full accept a draw from
  the bonus row.  The emitted token is distributed exactly as ``p_j``.
  Draws come from an explicit ``torch.Generator``.

``p_j`` is the temperature/top-k/top-p filtered distribution of
:func:`repro_torch.serving.sampling.filter_logits`, the filter the
draftless engine samples through.
"""
from __future__ import annotations

import torch

from repro_torch.serving.sampling import categorical, filter_logits

__all__ = ["verify_batched"]


def verify_batched(gen: torch.Generator, logits: torch.Tensor,
                   drafts: torch.Tensor, draft_lens: torch.Tensor,
                   temperatures: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor):
    """Score the drafts of every slot and keep the longest accepted prefix.

    logits (B, R, V) one row per lane; drafts (B, R-1) proposed tokens
    (garbage past ``draft_lens``); draft_lens (B,) valid drafts per slot
    (0: a plain decode lane); temperatures / top_ks / top_ps (B,) as in
    :func:`repro_torch.serving.sampling.sample_batched`.

    Returns ``(out (B, R) int32, accept_len (B,) int32)``: slot ``b`` emits
    ``out[b, :accept_len[b] + 1]``; entries past that are unspecified.
    """
    B, R, V = logits.shape
    dev = logits.device
    lg = logits.float()
    arg = torch.argmax(lg, dim=-1)                          # (B, R)
    knobs = [t[:, None].expand(B, R)
             for t in (temperatures, top_ks, top_ps)]
    filt = filter_logits(lg, *knobs)                        # (B, R, V)
    probs = torch.softmax(filt, dim=-1)
    greedy = (temperatures <= 0)[:, None]
    draft = drafts[:, :R - 1].long()                        # (B, R-1)
    p_draft = torch.gather(probs[:, :-1], -1, draft[..., None])[..., 0]
    u = torch.rand((B, R - 1), generator=gen, device=dev)
    acc = torch.where(greedy, draft == arg[:, :-1], u < p_draft)
    acc &= (torch.arange(R - 1, device=dev)[None]
            < draft_lens[:, None].long())
    a = torch.cumprod(acc.to(torch.int32), dim=-1).sum(-1)  # (B,)
    padded = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=-1)
    resid = filt.masked_fill(
        torch.arange(V, device=dev) == padded[..., None], -torch.inf)
    t_rej = torch.where(greedy, arg, categorical(gen, resid))
    t_samp = torch.where(greedy, arg, categorical(gen, filt))
    tail = torch.where(a[:, None] < draft_lens[:, None].long(), t_rej,
                       t_samp)
    out = torch.where(torch.arange(R, device=dev)[None] < a[:, None],
                      padded, tail)
    return out.to(torch.int32), a.to(torch.int32)
