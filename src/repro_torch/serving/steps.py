"""Serving step builders over the contiguous-cache decode (port of
``repro.serving.steps``).

``make_prefill_step`` runs the model's whole-sequence forward and
unembeds only the last position; ``make_serve_step`` runs one
``decode_step`` and picks each request's next token greedily.  Every LM
family of the port serves through them.  The reference's ``backend``
argument scopes its op registry, which the port does not have.

``jit_prefill_step`` / ``jit_serve_step`` keep the reference's names and
signatures for its sharded steps (GSPMD over a mesh, the decode over the
sequence-sharded contiguous cache) and return THIS rank's eager step, as
``training.train_step.jit_train_step`` does: params its shards
(``model.init(seed, shard=model.shard_fn(mesh))``), the batch and the
tokens global (the step keeps the rank's slice by ``rules.batch_spec``),
the cache its shard (``model.init_decode_cache(batch, max_seq,
mesh=mesh)``, cut by ``rules.cache_tree``).  Each returns the global
result on every rank: the prefill's last-position logits (B, V), the
serve step's next tokens (B,) (one int32 gather over the data axes).  A
one-rank mesh runs the one-device step.  ``abstract_cache`` is the
cache's tree as meta tensors.  The paged engine (``serving.engine``) is
the other serving path, for the decoders.
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


def _check_rules(model, mesh, rules, params_shape, what: str) -> None:
    if rules.params_tree(params_shape) != model.sharding_rules(
            mesh).params_tree(params_shape):
        raise ValueError(f"{what}: rules give other specs than the model's "
                         "own sharding_rules(mesh)")


def gather_batch(x: torch.Tensor, entry, mesh) -> torch.Tensor:
    """The global batch of ``x`` (dim 0 this rank's block under a batch
    spec's first entry ``entry``: an axis, a tuple of them, or None),
    gathered over those axes in rank order (the last axis first)."""
    from repro_torch.distributed import collectives

    if entry is None:
        return x
    for a in reversed((entry,) if isinstance(entry, str) else entry):
        x = collectives.all_gather(x, mesh, a, dim=0)
    return x


def jit_prefill_step(model, mesh, rules, params_shape, batch_shape):
    """The reference's sharded prefill step, as an eager step of THIS
    rank (module docstring): ``step(params, batch) -> logits (B, V)``,
    ``params`` this rank's shards and ``batch`` the global one
    (``batch_shape``: its arrays' shapes); the forward of its batch slice
    on the mesh (``model.forward(mesh=, last_only=True)``), the logits
    gathered over the data axes.  ``rules`` must be the model's own."""
    from repro_torch.distributed.sharding import shard_leaf

    _check_rules(model, mesh, rules, params_shape, "jit_prefill_step")
    if mesh.devices == 1:
        return make_prefill_step(model)
    b_spec = {k: rules.batch_spec(tuple(v.shape))
              for k, v in batch_shape.items()}

    @torch.no_grad()
    def step(params, batch):
        batch = {k: shard_leaf(v, b_spec[k], mesh) for k, v in batch.items()}
        logits, _ = model.forward(params, batch["tokens"],
                                  batch.get("extra_embeds"), last_only=True,
                                  mesh=mesh)
        return gather_batch(logits[:, 0], b_spec["tokens"][0], mesh)

    return step


def jit_serve_step(model, mesh, rules, params_shape, cache_shape,
                   tokens_shape, donate: bool = True):
    """The reference's sharded decode step, as an eager step of THIS rank
    (module docstring): ``step(params, cache, tokens) -> (next_tokens (B,)
    int32, cache)``, the cache this rank's shard (``rules.cache_tree`` of
    ``cache_shape``, the whole cache's shapes) updated IN PLACE
    (``donate``, as the reference donates it; ``donate=False`` copies it
    first), the tokens global.  ``rules`` must be the model's own."""
    from repro_torch import tree as tree_lib
    from repro_torch.distributed.sharding import shard_leaf

    _check_rules(model, mesh, rules, params_shape, "jit_serve_step")
    t_spec = rules.batch_spec(tuple(tokens_shape.shape))
    max_seq = (int(cache_shape["k"].shape[2]) if "k" in cache_shape
               else None)
    one = mesh.devices == 1
    plain = make_serve_step(model)

    @torch.no_grad()
    def step(params, cache, tokens):
        if not donate:
            cache = tree_lib.map(torch.clone, cache)
        if one:
            return plain(params, cache, tokens)
        logits, cache = model.decode_step(
            params, cache, shard_leaf(tokens, t_spec, mesh), mesh=mesh,
            max_seq=max_seq)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return gather_batch(nxt, t_spec[0], mesh), cache

    return step


def abstract_cache(model, batch: int, max_seq: int):
    """``model.init_decode_cache(batch, max_seq)``'s tree as meta tensors
    (shapes and dtypes, allocated nowhere)."""
    from repro_torch.models.stacking import on_meta
    return on_meta(model).init_decode_cache(batch, max_seq)
