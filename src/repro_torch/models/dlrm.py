"""DLRM-DCNv2 (paper Table 3, RM1/RM2) on the card (port of
``repro.models.dlrm``), with the paper's BatchedTable embedding technique
as a switch: ``use_batched=True`` (the default) pools every table in one
launch of the hand-written kernel, ``False`` is the SingleTable baseline
with one gather per table.  :meth:`DLRM.loss` is differentiable end to
end: the BatchedTable pool through the hand-written backward kernel
(``core.embedding_api.embedding_bag``), SingleTable through
``index_select``'s own gradient, as the reference's ``jnp.take``.

Parameters are a dict with the JAX pytree's names and layouts:
``embedding`` (T*R, D), ``table_offsets`` (T,) int32, and ``bottom``,
``cross`` and ``top`` as lists of dicts (``w``/``b`` for an MLP layer,
``u``/``v``/``b`` for a low-rank cross layer).  The device of the
parameters chooses the path: CUDA runs the kernel, CPU its plain version.

On a mesh (``forward`` / ``loss`` with ``mesh=``, the reference's rules:
``embedding`` rows over ``model``, the MLP's ``w`` FSDP on its input dim
and split over ``model`` on its output dim, the cross layers' ``u`` / ``v``
as a Megatron pair): params are this rank's shards and the batch its
shard.  The pooled bags are each rank's row window
(``embedding_api.batched_table_lookup_sharded``: B4's window forward,
and its window backward for the gradient of the rank's rows) summed over
``model``; an MLP layer split on its output is gathered back whole; the
cross layers' partial products meet in a float32 SUM; the loss is the
global mean.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib
from repro_torch.config import DLRMConfig
from repro_torch.core import embedding_api
from repro_torch.models import stacking


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


def _mlp_init(gen, dims: Sequence[int], device) -> List[Dict]:
    return [{"w": _normal(gen, (a, b), a ** -0.5, device),
             "b": torch.zeros((b,), device=device)}
            for a, b in zip(dims[:-1], dims[1:])]


def _mlp_apply(layers, x, final_act: bool = False):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


class DLRM:
    def __init__(self, cfg: DLRMConfig, *, use_batched: bool = True,
                 device="cuda"):
        self.cfg = cfg
        self.use_batched = use_batched
        self.device = device_lib.resolve(device)
        self.inter_dim = cfg.bottom_mlp[-1] + cfg.num_tables * cfg.embedding_dim

    def init(self, seed: int = 0, shard=None) -> Dict:
        """Random float32 parameters from a seeded ``torch.Generator`` on the
        model's device, at the reference's scales (normal times fan-in^-0.5;
        embedding rows times D^-0.5; biases 0).  ``shard``: ``fn(path,
        leaf) -> leaf`` (``shard_fn``) applied to each leaf of the drawn
        tree, keeping this rank's shards."""
        cfg, dev = self.cfg, self.device
        gen = stacking.generator(seed, dev)
        emb = _normal(gen, (cfg.num_tables * cfg.num_embeddings,
                            cfg.embedding_dim), cfg.embedding_dim ** -0.5,
                      dev)
        offsets = torch.arange(cfg.num_tables, dtype=torch.int32,
                               device=dev) * cfg.num_embeddings
        d, r = self.inter_dim, cfg.cross_rank
        cross = [{"u": _normal(gen, (d, r), d ** -0.5, dev),
                  "v": _normal(gen, (r, d), r ** -0.5, dev),
                  "b": torch.zeros((d,), device=dev)}
                 for _ in range(cfg.cross_layers)]
        params = {
            "embedding": emb,
            "table_offsets": offsets,
            "bottom": _mlp_init(gen, (cfg.dense_features,) + cfg.bottom_mlp,
                                dev),
            "cross": cross,
            "top": _mlp_init(gen, (d,) + cfg.top_mlp, dev),
        }
        if shard is None:
            return params
        from repro_torch.distributed.sharding import map_with_path
        return map_with_path(shard, params)

    # ------------------------------------------------------------------ mesh
    def sharding_rules(self, mesh, axis: str = "model"):
        """The reference's rules for DLRM's params on ``mesh``."""
        from repro_torch.distributed.sharding import ShardingRules
        return ShardingRules(mesh, model_axis=axis)

    def shard_fn(self, mesh, axis: str = "model"):
        """``fn(path, leaf)``: this rank's shard of a full leaf."""
        from repro_torch.distributed.sharding import shard_leaf
        rules = self.sharding_rules(mesh, axis)
        return lambda path, t: shard_leaf(
            t, rules.param_spec(tuple(path), tuple(t.shape)), mesh)

    def shard_params(self, params, mesh, axis: str = "model") -> Dict:
        """This rank's shards of the whole params."""
        from repro_torch.distributed.sharding import map_with_path
        return map_with_path(self.shard_fn(mesh, axis), params)

    def tensor_parallel(self, mesh, axis: str = "model"):
        from repro_torch.distributed.sharding import TensorParallel
        cache = self.__dict__.setdefault("_tp_cache", {})
        key = (id(mesh), axis)
        if key not in cache:
            specs = self.sharding_rules(mesh, axis).params_tree(
                self.init_abstract())
            cache[key] = TensorParallel(mesh, specs, axis)
        return cache[key]

    def _forward_mesh(self, params, batch, mesh):
        from repro_torch.distributed import collectives

        tp = self.tensor_parallel(mesh)
        p = tp.gather_params(params)

        def dense(path, layer, x):
            if tp.split(*path, "w"):        # output dim split: gather it
                y = collectives.gather_replicated(
                    torch.matmul(tp.enter(x), layer["w"]), mesh, tp.axis)
                return y + layer["b"]
            return x @ layer["w"] + layer["b"]

        def mlp(name, x, final_act=False):
            layers = p[name]
            for i, l in enumerate(layers):
                x = dense((name, i), l, x)
                if i < len(layers) - 1 or final_act:
                    x = torch.relu(x)
            return x

        dense_x = mlp("bottom", batch["dense"], final_act=True)
        if tp.split("embedding"):
            pooled = embedding_api.batched_table_lookup_sharded(
                p["embedding"], p["table_offsets"], batch["indices"],
                mesh=mesh, axis=tp.axis)
        else:
            pooled = self.embedding_lookup(p, batch["indices"])
        B = dense_x.shape[0]
        x0 = torch.cat([dense_x, pooled.reshape(B, -1)], dim=-1)
        x = x0
        for i, l in enumerate(p["cross"]):
            if tp.split("cross", i, "u"):
                t = torch.matmul(torch.matmul(tp.enter(x), l["u"]), l["v"])
                t = tp.psum(t)
            else:
                t = (x @ l["u"]) @ l["v"]
            x = x0 * (t + l["b"]) + x
        return mlp("top", x)[:, 0]

    def init_abstract(self, dtype=torch.float32) -> Dict:
        """:meth:`init`'s tree as meta tensors, its float leaves in
        ``dtype`` (the reference's argument; ``table_offsets`` stays
        int32), drawn from nothing and allocated nowhere."""
        return tree_lib.map(
            lambda t: t.to(dtype) if t.is_floating_point() else t,
            stacking.init_abstract(self))

    def embedding_lookup(self, params, indices):
        """indices (B, T, L) -> pooled (B, T, D)."""
        if self.use_batched:    # the paper's BatchedTable: ONE fused lookup
            return embedding_api.embedding_bag(
                params["embedding"], params["table_offsets"], indices)
        R = self.cfg.num_embeddings     # SingleTable: T separate gathers
        tables = [params["embedding"][t * R:(t + 1) * R]
                  for t in range(self.cfg.num_tables)]
        return embedding_api.single_table_lookup(tables, indices)

    def forward(self, params, batch, *, mesh=None):
        """batch: {"dense": (B, 13) f32, "indices": (B, T, L) i32} -> (B,)
        logits.  ``mesh``: this rank's shards and batch shard (module
        docstring)."""
        if mesh is not None:
            return self._forward_mesh(params, batch, mesh)
        dense = _mlp_apply(params["bottom"], batch["dense"], final_act=True)
        pooled = self.embedding_lookup(params, batch["indices"])
        B = dense.shape[0]
        x0 = torch.cat([dense, pooled.reshape(B, -1)], dim=-1)
        x = x0
        for l in params["cross"]:      # DCNv2 low-rank cross layers
            x = x0 * ((x @ l["u"]) @ l["v"] + l["b"]) + x
        return _mlp_apply(params["top"], x)[:, 0]

    def loss(self, params, batch, *, mesh=None):
        """Mean binary cross-entropy of the logits against ``label``, in
        the numerically stable form.  ``mesh``: the global mean (the
        rank's sum over the global batch, summed over the data axes)."""
        z = self.forward(params, batch, mesh=mesh).float()
        y = batch["label"].float()
        bce = (torch.clamp_min(z, 0) - z * y
               + torch.log1p(torch.exp(-z.abs())))
        if mesh is None:
            return torch.mean(bce)
        from repro_torch.distributed import collectives
        from repro_torch.launch.mesh import data_axes
        dp = data_axes(mesh)
        count = float(bce.numel())
        for a in dp:
            count *= mesh.size(a)
        return collectives.reduce_from(bce.sum() / count, mesh, dp)
