"""Zamba2 hybrid (port of ``repro.models.zamba2``): a Mamba2 backbone and
ONE weight-shared attention + MLP block that runs before each group of
``hybrid_attn_every`` mamba layers.

Parameters keep the reference's tree: ``embed``, ``mamba`` (``ln``,
``ssm``; stacked twice, ``(G, per_group, ...)``), ``shared_attn`` (``ln1``,
``attn``, ``ln2``, ``mlp``), ``final_norm`` and ``head``.  Decode keeps a
contiguous K/V cache per application of the shared block (one a group)
and the mamba layers' conv and SSM states.  All of it is plain PyTorch;
the reference reaches no Pallas kernel on this path.

On a ``(data, model)`` mesh (``mesh=`` on :meth:`Zamba2LM.forward`,
:meth:`Zamba2LM.loss` and :meth:`Zamba2LM.decode_step`; ``models.mesh_lm``
for the rules and the shards): leaves gathered over ``data`` (FSDP), each
mamba layer this rank's SSD heads (``layers.ssm``'s ``*_tp``), the shared
block's attention and MLP split as the decoders' are, its K/V cache
sequence-sharded (``models.transformer.decode_attention``), the conv
state this rank's block of channels and ``h`` its heads, the embedding,
the head and the loss vocabulary-parallel.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import ssm as ssm_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.mlp import mlp_apply, mlp_apply_mesh, mlp_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init
from repro_torch.models import stacking
from repro_torch.models.mesh_lm import MeshLM, alloc_cache, cut_tree, seq_split
from repro_torch.models.transformer import decode_attention
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss

SHARED = ("shared_attn", "attn")
SHARED_MLP = ("shared_attn", "mlp")
MAMBA = ("mamba", "ssm")


class Zamba2LM(MeshLM):
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 q_chunk: int = 512, remat=True):
        assert cfg.num_layers % cfg.hybrid_attn_every == 0
        self.cfg = cfg
        self.q_chunk = q_chunk
        self.remat = remat_lib.resolve(remat)
        self.device = device_lib.resolve(device)
        self.dtype = stacking.DTYPES[cfg.dtype]
        self.n_groups = cfg.num_layers // cfg.hybrid_attn_every
        self.per_group = cfg.hybrid_attn_every

    def init(self, seed: int = 0, shard=None) -> Dict:
        """Random parameters from a seeded generator on the model's
        device, in the reference's tree, shapes and per-leaf dtypes.
        ``shard``: ``fn(path, leaf)`` applied to each leaf as it is drawn
        (a layer's before they are stacked; ``shard_fn``)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)
        d = cfg.d_model
        mamba = stacking.init_stacked(
            self.n_groups, lambda: stacking.init_stacked(
                self.per_group, lambda: cut_tree(shard, ("mamba",), {
                    "ln": rmsnorm_init(d, dt, dev),
                    "ssm": ssm_lib.ssm_init(gen, d, cfg.ssm, dt, dev)})))
        shared = cut_tree(shard, ("shared_attn",), {
            "ln1": rmsnorm_init(d, dt, dev),
            "attn": attn_lib.attention_init(gen, d, cfg.attention, dt, dev),
            "ln2": rmsnorm_init(d, dt, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, dt, dev),
        })

        def top(name, tree):
            return cut_tree(shard, (name,), tree)

        return {
            "embed": top("embed", embedding_init(gen, cfg.vocab_size, d, dt,
                                                 dev)),
            "mamba": mamba,
            "shared_attn": shared,
            "final_norm": top("final_norm", rmsnorm_init(d, dt, dev)),
            "head": top("head", embedding_init(gen, cfg.vocab_size, d, dt,
                                               dev)),
        }

    def init_abstract(self) -> Dict:
        """:meth:`init`'s tree (keys, shapes, dtypes) as meta tensors,
        drawn from nothing and allocated nowhere."""
        return stacking.init_abstract(self)

    def _group(self, shared, gp, x, positions):
        """The shared attention + MLP block, then the group's mamba
        layers (``gp``: ``per_group``-stacked)."""
        cfg = self.cfg
        h, _ = attn_lib.attention_block(
            shared["attn"], rmsnorm(shared["ln1"], x, cfg.norm_eps),
            positions, cfg.attention, chunk=self.q_chunk)
        x = x + h
        x = x + mlp_apply(shared["mlp"],
                          rmsnorm(shared["ln2"], x, cfg.norm_eps), cfg.act)
        for lp in stacking.unstack(gp, self.per_group):
            x = x + ssm_lib.ssm_chunked(
                lp["ssm"], rmsnorm(lp["ln"], x, cfg.norm_eps), cfg.ssm,
                cfg.d_model)
        return x

    def _group_mesh(self, shared, gp, x, positions, tp):
        """:meth:`_group` on a mesh: ``shared`` the shared block gathered
        over the data axis, ``gp`` this rank's shards of the group's
        mamba layers."""
        cfg = self.cfg
        x = x + attn_lib.attention_block_tp(
            shared["attn"], rmsnorm(shared["ln1"], x, cfg.norm_eps),
            positions, cfg.attention, tp, chunk=self.q_chunk, path=SHARED)
        x = x + mlp_apply_mesh(shared["mlp"],
                               rmsnorm(shared["ln2"], x, cfg.norm_eps),
                               cfg.act, tp, SHARED_MLP)
        for lp in stacking.unstack(gp, self.per_group):
            lp = tp.gather_params(lp, "mamba")
            x = x + ssm_lib.ssm_chunked_tp(
                lp["ssm"], rmsnorm(lp["ln"], x, cfg.norm_eps), cfg.ssm,
                cfg.d_model, tp)
        return x

    def _hidden_mesh(self, params, tokens, mesh):
        cfg = self.cfg
        tp = self.tensor_parallel(mesh)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k != "mamba"})
        x = self._embed_tp(top, tokens, tp)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        group = functools.partial(self._group_mesh, tp=tp)
        if torch.is_grad_enabled():
            group = remat_lib.wrap(group, self.remat)
        for gp in stacking.unstack(params["mamba"], self.n_groups):
            x = group(top["shared_attn"], gp, x, positions)
        return x, top, tp

    def forward(self, params, tokens, extra_embeds=None, *,
                last_only: bool = False, mesh=None):
        """tokens (B, S) -> (logits (B, S, V) f32, 0); S a multiple of the
        SSM chunk or below it.  ``extra_embeds`` is ignored, as in the
        reference.  With grad enabled each group runs under ``remat``.
        ``mesh``: params this rank's shards, tokens its batch shard; its
        logits come back whole over ``model``."""
        cfg = self.cfg
        if mesh is not None:
            x, top, tp = self._hidden_mesh(params, tokens, mesh)
            if last_only:
                x = x[:, -1:]
            x = rmsnorm(top["final_norm"], x, cfg.norm_eps)
            return (self._logits_mesh(top, x, tp),
                    torch.zeros((), dtype=torch.float32, device=x.device))
        x = embed(params["embed"], tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        group = (remat_lib.wrap(self._group, self.remat)
                 if torch.is_grad_enabled() else self._group)
        for gp in stacking.unstack(params["mamba"], self.n_groups):
            x = group(params["shared_attn"], gp, x, positions)
        if last_only:
            x = x[:, -1:]
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return (unembed(params["head"], x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ---------------------------------------------------------------- decode
    def init_decode_cache(self, batch: int, max_seq: int, *, mesh=None):
        """The shared block's K/V (G, batch, max_seq, KV, hd), the mamba
        layers' conv and SSM states and seq_lens; with ``mesh``, this
        rank's shard of them (``cache_spec``)."""
        cfg = self.cfg
        a = cfg.attention
        dims = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm)
        G, PG = self.n_groups, self.per_group
        dt = self.dtype
        kv = (G, batch, max_seq, a.num_kv_heads, a.head_dim)
        return alloc_cache(
            {"k": (kv, dt), "v": (kv, dt),
             "conv": ((G, PG, batch, cfg.ssm.d_conv - 1, dims.conv_dim), dt),
             "h": ((G, PG, batch, dims.num_heads, cfg.ssm.head_dim,
                    cfg.ssm.d_state), torch.float32),
             "seq_lens": ((batch,), torch.int32)}, self.device,
            self.sharding_rules(mesh) if mesh is not None else None, mesh)

    def decode_step(self, params, cache, tokens, *, mesh=None,
                    max_seq: Optional[int] = None):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache updated IN
        PLACE: each group's shared-block application writes its K/V at
        ``seq_lens`` and attends over positions <= seq_lens; each mamba
        layer steps its conv and SSM state.  ``mesh``: params, tokens and
        the cache this rank's shards (module docstring), ``max_seq`` the
        whole K/V cache's length."""
        if mesh is not None:
            return self._decode_step_mesh(params, cache, tokens, mesh,
                                          max_seq)
        cfg = self.cfg
        seq_lens = cache["seq_lens"]
        x = embed(params["embed"], tokens)                  # (B, D)
        shared = params["shared_attn"]
        for g in range(self.n_groups):
            h = rmsnorm(shared["ln1"], x[:, None], cfg.norm_eps)
            ctx = decode_attention(shared["attn"], h, cache["k"][g],
                                   cache["v"][g], seq_lens, cfg.attention)
            x = x + torch.matmul(ctx, shared["attn"]["wo"])
            h = mlp_apply(shared["mlp"],
                          rmsnorm(shared["ln2"], x[:, None], cfg.norm_eps),
                          cfg.act)
            x = x + h[:, 0]
            for j in range(self.per_group):
                lp = stacking.layer(stacking.layer(params["mamba"], g), j)
                o, st = ssm_lib.ssm_step(
                    lp["ssm"], rmsnorm(lp["ln"], x[:, None], cfg.norm_eps),
                    {"conv": cache["conv"][g, j], "h": cache["h"][g, j]},
                    cfg.ssm, cfg.d_model)
                cache["conv"][g, j] = st["conv"]
                cache["h"][g, j] = st["h"]
                x = x + o[:, 0]
        x = rmsnorm(params["final_norm"], x[:, None], cfg.norm_eps)
        logits = unembed(params["head"], x)[:, 0]
        seq_lens.add_(1)
        return logits, cache

    def _decode_step_mesh(self, params, cache, tokens, mesh, max_seq):
        cfg = self.cfg
        tp = self.tensor_parallel(mesh)
        split = seq_split(tp, max_seq)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k != "mamba"})
        shared = top["shared_attn"]
        seq_lens = cache["seq_lens"]
        x = self._embed_tp(top, tokens, tp)                 # (B, D)
        for g in range(self.n_groups):
            h = rmsnorm(shared["ln1"], x[:, None], cfg.norm_eps)
            ctx = decode_attention(shared["attn"], h, cache["k"][g],
                                   cache["v"][g], seq_lens, cfg.attention,
                                   tp=tp, path=SHARED, seq_split=split)
            if tp.split(*SHARED, "wo"):
                x = x + attn_lib.out_proj_tp(ctx, shared["attn"]["wo"], tp)
            else:
                x = x + torch.matmul(ctx, shared["attn"]["wo"])
            h = rmsnorm(shared["ln2"], x[:, None], cfg.norm_eps)
            x = x + mlp_apply_mesh(shared["mlp"], h, cfg.act, tp,
                                   SHARED_MLP)[:, 0]
            for j in range(self.per_group):
                lp = tp.gather_params(stacking.layer(stacking.layer(
                    params["mamba"], g), j), "mamba")
                o, st = ssm_lib.ssm_step_tp(
                    lp["ssm"], rmsnorm(lp["ln"], x[:, None], cfg.norm_eps),
                    {"conv": cache["conv"][g, j], "h": cache["h"][g, j]},
                    cfg.ssm, cfg.d_model, tp)
                cache["conv"][g, j] = st["conv"]
                cache["h"][g, j] = st["h"]
                x = x + o[:, 0]
        x = rmsnorm(top["final_norm"], x[:, None], cfg.norm_eps)
        logits = self._unembed_tp(top, x, tp)[:, 0]
        seq_lens.add_(1)
        return logits, cache

    def loss(self, params, batch, *, mesh=None):
        """Next-token CE.  ``mesh``: params this rank's shards and batch
        its shard of the batch; the global loss on every rank."""
        if mesh is not None:
            x, top, tp = self._hidden_mesh(params, batch["tokens"], mesh)
            x = rmsnorm(top["final_norm"], x, self.cfg.norm_eps)
            return self._ce_mesh(top, x, batch["tokens"], None, tp)
        logits, _ = self.forward(params, batch["tokens"])
        return next_token_loss(logits, batch["tokens"])
