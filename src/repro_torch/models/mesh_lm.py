"""What the LM families share on a mesh of ranks: the reference's rules
for their params, the cut of a rank's shard (as drawn, or from a whole
tree), the ``TensorParallel`` their sharded paths read, the
vocabulary-parallel embedding, head and loss, and the allocation of a
rank's shard of a decode cache.

A model mixes in :class:`MeshLM` and keeps ``cfg`` and ``init_abstract``;
its ``init(seed, shard=)`` passes each leaf through ``shard`` as soon as it
is drawn (:func:`cut_tree`), so a rank holds only its shard of the same
values.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.layers.embedding import (
    embed, embed_vocab_parallel, unembed, unembed_vocab_parallel,
    vocab_parallel_cross_entropy)
from repro_torch.training.losses import softmax_cross_entropy


def cut_tree(cut, prefix: Tuple[str, ...], tree):
    """``cut(path, leaf)`` over a dict of tensors, ``path`` its keys below
    ``prefix``; the identity when ``cut`` is None."""
    if cut is None:
        return tree
    if isinstance(tree, dict):
        return {k: cut_tree(cut, prefix + (k,), v) for k, v in tree.items()}
    return cut(prefix, tree)


def alloc_cache(shapes: Dict[str, Tuple[tuple, torch.dtype]], device,
                rules=None, mesh=None) -> Dict[str, torch.Tensor]:
    """Zeroed cache leaves ``{name: (shape, dtype)}`` on ``device``; with
    ``rules`` and ``mesh``, each at the shape of this rank's block under
    ``rules.cache_spec``, so no rank allocates the whole cache."""
    from repro_torch.distributed.sharding import shard_shape

    out = {}
    for name, (shape, dtype) in shapes.items():
        if mesh is not None:
            shape = shard_shape(shape, rules.cache_spec((name,), shape), mesh)
        out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def seq_split(tp, max_seq: Optional[int]) -> bool:
    """Whether the rules split a contiguous cache's sequence (length
    ``max_seq``, the whole cache's) over ``tp``'s axis: its size > 1 and
    dividing it, ``cache_spec``'s rule."""
    if tp.size == 1:
        return False
    if max_seq is None:
        raise ValueError("decode_step on a mesh: give max_seq, the whole "
                         "cache's length (the rank's shard does not say "
                         "whether the rules split it)")
    return max_seq % tp.size == 0


class MeshLM:
    """The mesh half a model family shares (module docstring)."""

    def sharding_rules(self, mesh, axis: str = "model"):
        """The reference's rules for this model's params on ``mesh``
        (attention projections split on whole heads only, where the
        model has attention), as its dry run builds them."""
        from repro_torch.distributed.sharding import ShardingRules
        a = getattr(self.cfg, "attention", None)
        return ShardingRules(mesh, model_axis=axis,
                             head_dim=a.head_dim if a else None)

    def shard_fn(self, mesh, axis: str = "model"):
        """``fn(path, leaf)``: this rank's shard of a full leaf at ``path``
        (for ``init``'s ``shard``)."""
        from repro_torch.distributed.sharding import shard_leaf
        rules = self.sharding_rules(mesh, axis)
        return lambda path, t: shard_leaf(
            t, rules.param_spec(tuple(path), tuple(t.shape)), mesh)

    def shard_params(self, params, mesh, axis: str = "model") -> Dict:
        """This rank's shard of params (:meth:`sharding_rules`): a full
        leaf is cut, a leaf already of its shard's shape (from
        ``init(shard=...)``) is kept; any other shape raises."""
        from repro_torch.distributed.sharding import shard_leaf, shard_shape
        rules = self.sharding_rules(mesh, axis)
        full = self.init_abstract()

        def walk(path, p, f):
            if isinstance(p, dict):
                return {k: walk(path + (k,), p[k], f[k]) for k in p}
            spec = rules.param_spec(path, tuple(f.shape))
            if tuple(p.shape) == tuple(f.shape):
                return shard_leaf(p, spec, mesh)
            want = shard_shape(tuple(f.shape), spec, mesh)
            if tuple(p.shape) != want:
                raise ValueError(f"{'/'.join(path)}: shape {tuple(p.shape)} "
                                 f"is neither the full {tuple(f.shape)} nor "
                                 f"this rank's shard {want}")
            return p

        return walk((), params, full)

    def tensor_parallel(self, mesh, axis: str = "model"):
        """The ``TensorParallel`` the sharded paths read (which leaves are
        split, from the specs of ``init_abstract``'s tree)."""
        from repro_torch.distributed.sharding import TensorParallel
        cache = self.__dict__.setdefault("_tp_cache", {})
        key = (id(mesh), axis)
        if key not in cache:
            specs = self.sharding_rules(mesh, axis).params_tree(
                self.init_abstract())
            cache[key] = TensorParallel(mesh, specs, axis)
        return cache[key]

    # ------------------------------------------- vocabulary-parallel ends
    def _embed_tp(self, params, tokens, tp):
        if tp.split("embed", "table"):
            return embed_vocab_parallel(params["embed"], tokens, tp)
        return embed(params["embed"], tokens)

    def _unembed_tp(self, params, x, tp):
        """Serving's head: the logits whole on every rank (no gradient)."""
        name = "head" if "head" in params else "embed"
        if tp.split(name, "table"):
            return unembed_vocab_parallel(params[name], x, tp)
        return unembed(params[name], x)

    def _logits_mesh(self, top, x, tp):
        """The training forward's head: this rank's batch shard's logits
        whole over the axis, with a gradient (a split head's block of them
        gathered for a replicated consumer)."""
        name = "head" if "head" in top else "embed"
        if not tp.split(name, "table"):
            return unembed(top[name], x)
        return tp.gather_whole(unembed(top[name], tp.enter(x)), dim=-1)

    def _ce_mesh(self, top, x, tokens, loss_mask, tp):
        """The global next-token CE from this rank's hidden states ``x``
        (B, S, D) of its batch shard: its CE sum over the global count
        (vocabulary-parallel where the head is split, no logits gathered),
        summed over the data axes."""
        from repro_torch.distributed import collectives
        from repro_torch.launch.mesh import data_axes

        mesh = tp.mesh
        name = "head" if "head" in top else "embed"
        if tp.split(name, "table"):
            nll = vocab_parallel_cross_entropy(top[name], x[:, :-1],
                                               tokens[:, 1:], tp)
        else:
            nll = softmax_cross_entropy(unembed(top[name], x[:, :-1]),
                                        tokens[:, 1:])
        dp = data_axes(mesh)
        if loss_mask is None:
            local = nll.sum()
            count = float(nll.numel())
            for a in dp:
                count *= mesh.size(a)
        else:
            m = loss_mask[:, 1:].float()
            local = torch.sum(nll * m)
            count = m.sum()
            for a in dp:
                collectives.all_reduce(count, mesh, a)
            count = count.clamp_min(1.0)
        return collectives.reduce_from(local / count, mesh, dp)
