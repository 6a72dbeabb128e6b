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

    def init(self, seed: int = 0) -> Dict:
        """Random float32 parameters from a seeded ``torch.Generator`` on the
        model's device, at the reference's scales (normal times fan-in^-0.5;
        embedding rows times D^-0.5; biases 0)."""
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
        return {
            "embedding": emb,
            "table_offsets": offsets,
            "bottom": _mlp_init(gen, (cfg.dense_features,) + cfg.bottom_mlp,
                                dev),
            "cross": cross,
            "top": _mlp_init(gen, (d,) + cfg.top_mlp, dev),
        }

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

    def forward(self, params, batch):
        """batch: {"dense": (B, 13) f32, "indices": (B, T, L) i32} -> (B,)
        logits."""
        dense = _mlp_apply(params["bottom"], batch["dense"], final_act=True)
        pooled = self.embedding_lookup(params, batch["indices"])
        B = dense.shape[0]
        x0 = torch.cat([dense, pooled.reshape(B, -1)], dim=-1)
        x = x0
        for l in params["cross"]:      # DCNv2 low-rank cross layers
            x = x0 * ((x @ l["u"]) @ l["v"] + l["b"]) + x
        return _mlp_apply(params["top"], x)[:, 0]

    def loss(self, params, batch):
        """Mean binary cross-entropy of the logits against ``label``, in
        the numerically stable form."""
        z = self.forward(params, batch).float()
        y = batch["label"].float()
        return torch.mean(torch.clamp_min(z, 0) - z * y
                          + torch.log1p(torch.exp(-z.abs())))
