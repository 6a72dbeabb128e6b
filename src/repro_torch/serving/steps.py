"""Serving step builders over the contiguous-cache decode (port of the
unsharded halves of ``repro.serving.steps``).

``make_prefill_step`` runs the model's whole-sequence forward and
unembeds only the last position; ``make_serve_step`` runs one
``decode_step`` and picks each request's next token greedily.  Every LM
family of the port serves through them.  The reference's ``backend``
argument scopes its op registry, which the port does not have; its
``jit_*_step`` and ``abstract_cache`` shard the steps over a mesh (ROADMAP
A10, A13).  The paged engine (``serving.engine``) is the other serving
path, for the decoders.
"""
from __future__ import annotations

import torch


def make_prefill_step(model):
    """(params, batch) -> last-position logits (B, V) f32.  batch: tokens
    (B, S) [+ extra_embeds: the VLM's vision stub or whisper's frames]."""
    def step(params, batch):
        logits, _ = model.forward(params, batch["tokens"],
                                  batch.get("extra_embeds"), last_only=True)
        return logits[:, 0]
    return step


def make_serve_step(model):
    """(params, cache, tokens) -> (next_tokens (B,) int32, cache): one
    decode step, greedy.  The model updates the cache in place."""
    def step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return step
