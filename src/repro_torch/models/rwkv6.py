"""RWKV6 "Finch" LM (port of ``repro.models.rwkv6``): attention-free, so
there is no KV cache to page; serving carries a constant-size recurrent
state a request instead (:meth:`RWKV6LM.init_decode_cache`).

Parameters keep the reference's tree: ``embed``, ``ln0``, ``layers``
(``ln1``, ``ln2``, ``tm`` the time mix, ``cm`` the channel mix, stacked on
a leading ``L`` axis), ``final_norm`` and ``head``.  All of it is plain
PyTorch; the reference reaches no Pallas kernel on this path.

On a ``(data, model)`` mesh (``mesh=`` on :meth:`RWKV6LM.forward`,
:meth:`RWKV6LM.loss` and :meth:`RWKV6LM.decode_step`; ``models.mesh_lm``
for the rules and the shards): each layer's leaves are gathered over
``data`` (FSDP), the time mix runs this rank's heads and the channel mix
its blocks (``layers.rwkv``'s ``*_tp``), the embedding, the head and the
loss are vocabulary-parallel.  The decode state is this rank's shard by
``cache_spec``: ``S`` its heads, ``tm_shift`` / ``cm_shift`` its block of
D (gathered whole for the token shift).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.layers import rwkv as rwkv_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.norm import layernorm, layernorm_init
from repro_torch.models import stacking
from repro_torch.models.mesh_lm import MeshLM, alloc_cache, cut_tree
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class RWKV6LM(MeshLM):
    def __init__(self, cfg: ModelConfig, *, device="cuda", remat=True):
        self.cfg = cfg
        self.remat = remat_lib.resolve(remat)
        self.device = device_lib.resolve(device)
        self.dtype = stacking.DTYPES[cfg.dtype]

    def init(self, seed: int = 0, shard=None) -> Dict:
        """Random parameters from a seeded generator on the model's
        device, in the reference's tree, shapes and per-leaf dtypes.
        ``shard``: ``fn(path, leaf)`` applied to each leaf as it is drawn
        (a layer's before they are stacked; ``shard_fn``)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)
        d = cfg.d_model
        layers = stacking.init_stacked(cfg.num_layers, lambda: cut_tree(
            shard, ("layers",), {
                "ln1": layernorm_init(d, dt, dev),
                "ln2": layernorm_init(d, dt, dev),
                "tm": rwkv_lib.rwkv_time_mix_init(gen, d, cfg.rwkv, dt, dev),
                "cm": rwkv_lib.rwkv_channel_mix_init(gen, d, cfg.d_ff, dt,
                                                     dev)}))
        def top(name, tree):
            return cut_tree(shard, (name,), tree)

        return {
            "embed": top("embed", embedding_init(gen, cfg.vocab_size, d, dt,
                                                 dev)),
            "ln0": top("ln0", layernorm_init(d, dt, dev)),
            "layers": layers,
            "final_norm": top("final_norm", layernorm_init(d, dt, dev)),
            "head": top("head", embedding_init(gen, cfg.vocab_size, d, dt,
                                               dev)),
        }

    def init_abstract(self) -> Dict:
        """:meth:`init`'s tree (keys, shapes, dtypes) as meta tensors,
        drawn from nothing and allocated nowhere."""
        return stacking.init_abstract(self)

    def _block(self, lp, x):
        cfg = self.cfg
        x = x + rwkv_lib.time_mix_chunked(
            lp["tm"], layernorm(lp["ln1"], x, cfg.norm_eps), cfg.rwkv)
        h, _ = rwkv_lib.channel_mix(lp["cm"],
                                    layernorm(lp["ln2"], x, cfg.norm_eps))
        return x + h

    def _block_mesh(self, lp, x, tp):
        cfg = self.cfg
        lp = tp.gather_params(lp, "layers")
        x = x + rwkv_lib.time_mix_chunked_tp(
            lp["tm"], layernorm(lp["ln1"], x, cfg.norm_eps), cfg.rwkv, tp)
        h, _ = rwkv_lib.channel_mix_tp(
            lp["cm"], layernorm(lp["ln2"], x, cfg.norm_eps), tp)
        return x + h

    def _hidden_mesh(self, params, tokens, mesh):
        """The forward on a mesh up to the final norm: (x, the top-level
        params gathered over the data axis, the ``TensorParallel``)."""
        cfg = self.cfg
        tp = self.tensor_parallel(mesh)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k != "layers"})
        x = layernorm(top["ln0"], self._embed_tp(top, tokens, tp))
        block = functools.partial(self._block_mesh, tp=tp)
        if torch.is_grad_enabled():
            block = remat_lib.wrap(block, self.remat)
        for lp in stacking.unstack(params["layers"], cfg.num_layers):
            x = block(lp, x)
        return x, top, tp

    def forward(self, params, tokens, extra_embeds=None, *,
                last_only: bool = False, mesh=None):
        """tokens (B, S) -> (logits (B, S, V) f32, 0).  ``extra_embeds`` is
        taken and ignored, as in the reference; S must be a multiple of
        the time mix's chunk (32) or below it.  ``mesh``: params this
        rank's shards, tokens its batch shard; its logits come back whole
        over ``model``."""
        cfg = self.cfg
        if mesh is not None:
            x, top, tp = self._hidden_mesh(params, tokens, mesh)
            if last_only:
                x = x[:, -1:]
            x = layernorm(top["final_norm"], x, cfg.norm_eps)
            return (self._logits_mesh(top, x, tp),
                    torch.zeros((), dtype=torch.float32, device=x.device))
        x = layernorm(params["ln0"], embed(params["embed"], tokens))
        block = (remat_lib.wrap(self._block, self.remat)
                 if torch.is_grad_enabled() else self._block)
        for lp in stacking.unstack(params["layers"], cfg.num_layers):
            x = block(lp, x)
        if last_only:
            x = x[:, -1:]
        x = layernorm(params["final_norm"], x, cfg.norm_eps)
        return (unembed(params["head"], x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ---------------------------------------------------------------- decode
    def init_decode_cache(self, batch: int, max_seq: int = 0, *, mesh=None):
        """The recurrent state of ``batch`` requests (``max_seq`` is
        unused: the state does not grow); with ``mesh``, this rank's shard
        of it (``cache_spec``)."""
        cfg = self.cfg
        L, D = cfg.num_layers, cfg.d_model
        N = cfg.rwkv.head_size
        dt = self.dtype
        return alloc_cache(
            {"tm_shift": ((L, batch, D), dt), "cm_shift": ((L, batch, D), dt),
             "S": ((L, batch, D // N, N, N), torch.float32),
             "seq_lens": ((batch,), torch.int32)}, self.device,
            self.sharding_rules(mesh) if mesh is not None else None, mesh)

    def decode_step(self, params, cache, tokens, *, mesh=None,
                    max_seq: Optional[int] = None):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache updated IN
        PLACE.  The time mix's shift holds the layer-normed input ``h``,
        as the reference's does.  ``mesh``: params, tokens and the cache
        this rank's shards (module docstring); ``max_seq`` is unused."""
        if mesh is not None:
            return self._decode_step_mesh(params, cache, tokens, mesh)
        cfg = self.cfg
        x = layernorm(params["ln0"], embed(params["embed"], tokens))  # (B,D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = stacking.layer(lp_all, i)
            h = layernorm(lp["ln1"], x[:, None], cfg.norm_eps)
            o, st = rwkv_lib.time_mix_step(
                lp["tm"], h, {"shift": cache["tm_shift"][i],
                              "S": cache["S"][i]}, cfg.rwkv)
            x = x + o[:, 0]
            cache["tm_shift"][i] = h[:, 0]
            cache["S"][i] = st["S"]
            h = layernorm(lp["ln2"], x[:, None], cfg.norm_eps)
            o, last = rwkv_lib.channel_mix(lp["cm"], h, cache["cm_shift"][i])
            cache["cm_shift"][i] = last
            x = x + o[:, 0]
        x = layernorm(params["final_norm"], x[:, None], cfg.norm_eps)
        logits = unembed(params["head"], x)[:, 0]
        cache["seq_lens"].add_(1)
        return logits, cache

    def _decode_step_mesh(self, params, cache, tokens, mesh):
        cfg = self.cfg
        tp = self.tensor_parallel(mesh)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k != "layers"})
        D = cfg.d_model
        split = cache["tm_shift"].shape[-1] != D      # D over model
        lo, hi = tp.bounds(D) if split else (0, D)

        def whole(t):
            return tp.gather(t, -1) if split else t

        x = layernorm(top["ln0"], self._embed_tp(top, tokens, tp))
        for i in range(cfg.num_layers):
            lp = tp.gather_params(stacking.layer(params["layers"], i),
                                  "layers")
            h = layernorm(lp["ln1"], x[:, None], cfg.norm_eps)
            o, S_new = rwkv_lib.time_mix_step_tp(
                lp["tm"], h, whole(cache["tm_shift"][i]), cache["S"][i],
                cfg.rwkv, tp)
            x = x + o[:, 0]
            cache["tm_shift"][i] = h[:, 0, lo:hi]
            cache["S"][i] = S_new
            h = layernorm(lp["ln2"], x[:, None], cfg.norm_eps)
            o, last = rwkv_lib.channel_mix_tp(
                lp["cm"], h, tp, prev=whole(cache["cm_shift"][i]))
            cache["cm_shift"][i] = last[:, lo:hi]
            x = x + o[:, 0]
        x = layernorm(top["final_norm"], x[:, None], cfg.norm_eps)
        logits = self._unembed_tp(top, x, tp)[:, 0]
        cache["seq_lens"].add_(1)
        return logits, cache

    def loss(self, params, batch, *, mesh=None):
        """Next-token CE.  ``mesh``: params this rank's shards and batch
        its shard of the batch; the global loss on every rank."""
        if mesh is not None:
            x, top, tp = self._hidden_mesh(params, batch["tokens"], mesh)
            x = layernorm(top["final_norm"], x, self.cfg.norm_eps)
            return self._ce_mesh(top, x, batch["tokens"], None, tp)
        logits, _ = self.forward(params, batch["tokens"])
        return next_token_loss(logits, batch["tokens"])
