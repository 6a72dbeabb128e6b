"""Zamba2 hybrid (port of ``repro.models.zamba2``): a Mamba2 backbone and
ONE weight-shared attention + MLP block that runs before each group of
``hybrid_attn_every`` mamba layers.

Parameters keep the reference's tree: ``embed``, ``mamba`` (``ln``,
``ssm``; stacked twice, ``(G, per_group, ...)``), ``shared_attn`` (``ln1``,
``attn``, ``ln2``, ``mlp``), ``final_norm`` and ``head``.  Decode keeps a
contiguous K/V cache per application of the shared block (one a group)
and the mamba layers' conv and SSM states.  All of it is plain PyTorch;
the reference reaches no Pallas kernel on this path.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import ssm as ssm_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init
from repro_torch.models import stacking
from repro_torch.models.transformer import decode_attention
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class Zamba2LM:
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

    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a seeded generator on the model's
        device, in the reference's tree, shapes and per-leaf dtypes."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)
        d = cfg.d_model
        mamba = stacking.init_stacked(
            self.n_groups, lambda: stacking.init_stacked(
                self.per_group, lambda: {
                    "ln": rmsnorm_init(d, dt, dev),
                    "ssm": ssm_lib.ssm_init(gen, d, cfg.ssm, dt, dev)}))
        shared = {
            "ln1": rmsnorm_init(d, dt, dev),
            "attn": attn_lib.attention_init(gen, d, cfg.attention, dt, dev),
            "ln2": rmsnorm_init(d, dt, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, dt, dev),
        }
        return {
            "embed": embedding_init(gen, cfg.vocab_size, d, dt, dev),
            "mamba": mamba,
            "shared_attn": shared,
            "final_norm": rmsnorm_init(d, dt, dev),
            "head": embedding_init(gen, cfg.vocab_size, d, dt, dev),
        }

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

    def forward(self, params, tokens, extra_embeds=None, *,
                last_only: bool = False):
        """tokens (B, S) -> (logits (B, S, V) f32, 0); S a multiple of the
        SSM chunk or below it.  ``extra_embeds`` is ignored, as in the
        reference.  With grad enabled each group runs under ``remat``."""
        cfg = self.cfg
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
    def init_decode_cache(self, batch: int, max_seq: int):
        cfg = self.cfg
        a = cfg.attention
        dims = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm)
        G, PG = self.n_groups, self.per_group
        dt, dev = self.dtype, self.device
        kv = (G, batch, max_seq, a.num_kv_heads, a.head_dim)
        return {
            "k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev),
            "conv": torch.zeros((G, PG, batch, cfg.ssm.d_conv - 1,
                                 dims.conv_dim), dtype=dt, device=dev),
            "h": torch.zeros((G, PG, batch, dims.num_heads,
                              cfg.ssm.head_dim, cfg.ssm.d_state),
                             dtype=torch.float32, device=dev),
            "seq_lens": torch.zeros((batch,), dtype=torch.int32,
                                    device=dev),
        }

    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache updated IN
        PLACE: each group's shared-block application writes its K/V at
        ``seq_lens`` and attends over positions <= seq_lens; each mamba
        layer steps its conv and SSM state."""
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

    def loss(self, params, batch):
        logits, _ = self.forward(params, batch["tokens"])
        return next_token_loss(logits, batch["tokens"])
