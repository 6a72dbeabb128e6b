"""Whisper-tiny encoder-decoder backbone (port of
``repro.models.whisper``).  The conv / mel front end is a stub, as in the
reference: the caller passes precomputed frame embeddings
(B, encoder_seq, d_model) as ``extra_embeds``.  LayerNorm and the GELU MLP
as in the original; RoPE on self-attention in place of learned positions,
none on cross-attention.

Parameters keep the reference's tree: ``embed``, ``enc_layers`` (``ln1``,
``attn``, ``ln2``, ``mlp``), ``enc_norm``, ``dec_layers`` (``ln1``,
``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``), each stacked
on a leading axis, ``final_norm`` and ``head``.  Decode keeps a contiguous
self-attention K/V cache and the cross-attention K/V (``xk``/``xv``)
computed once from the encoder by :meth:`WhisperEncDec.prefill_cross`.
All of it is plain PyTorch; the reference reaches no Pallas kernel on
this path.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norm import layernorm, layernorm_init
from repro_torch.models import stacking
from repro_torch.models.transformer import decode_attention
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class WhisperEncDec:
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 q_chunk: int = 512, remat=True):
        self.cfg = cfg
        self.q_chunk = q_chunk
        self.remat = remat_lib.resolve(remat)
        self.device = device_lib.resolve(device)
        self.dtype = stacking.DTYPES[cfg.dtype]

    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a seeded generator on the model's
        device, in the reference's tree, shapes and per-leaf dtypes."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)
        d, a = cfg.d_model, cfg.attention
        enc = stacking.init_stacked(cfg.encoder_layers, lambda: {
            "ln1": layernorm_init(d, dt, dev),
            "attn": attn_lib.attention_init(gen, d, a, dt, dev),
            "ln2": layernorm_init(d, dt, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, "gelu", dt, dev),
        })
        dec = stacking.init_stacked(cfg.num_layers, lambda: {
            "ln1": layernorm_init(d, dt, dev),
            "self_attn": attn_lib.attention_init(gen, d, a, dt, dev),
            "ln_x": layernorm_init(d, dt, dev),
            "cross_attn": attn_lib.attention_init(gen, d, a, dt, dev),
            "ln2": layernorm_init(d, dt, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, "gelu", dt, dev),
        })
        return {
            "embed": embedding_init(gen, cfg.vocab_size, d, dt, dev),
            "enc_layers": enc,
            "enc_norm": layernorm_init(d, dt, dev),
            "dec_layers": dec,
            "final_norm": layernorm_init(d, dt, dev),
            "head": embedding_init(gen, cfg.vocab_size, d, dt, dev),
        }

    def init_abstract(self) -> Dict:
        """:meth:`init`'s tree (keys, shapes, dtypes) as meta tensors,
        drawn from nothing and allocated nowhere."""
        return stacking.init_abstract(self)

    def _run_layers(self, body, x, layers, n: int, *args):
        """``body(lp, x, *args)`` over the ``n`` stacked layers, each under
        ``remat`` when grad is enabled."""
        fn = (remat_lib.wrap(body, self.remat) if torch.is_grad_enabled()
              else body)
        for lp in stacking.unstack(layers, n):
            x = fn(lp, x, *args)
        return x

    def _positions(self, x):
        B, S = x.shape[:2]
        return torch.arange(S, device=x.device).expand(B, S)

    def _enc_layer(self, lp, x):
        cfg = self.cfg
        h, _ = attn_lib.attention_block(
            lp["attn"], layernorm(lp["ln1"], x, cfg.norm_eps),
            self._positions(x), cfg.attention, causal=False,
            chunk=self.q_chunk)
        x = x + h
        return x + mlp_apply(lp["mlp"], layernorm(lp["ln2"], x, cfg.norm_eps),
                             "gelu")

    def encode(self, params, frames):
        """frames (B, encoder_seq, D) stub embeddings -> encoder output
        (non-causal self-attention)."""
        x = self._run_layers(self._enc_layer, frames.to(self.dtype),
                             params["enc_layers"], self.cfg.encoder_layers)
        return layernorm(params["enc_norm"], x, self.cfg.norm_eps)

    def _dec_layer(self, lp, x, enc):
        cfg = self.cfg
        h, _ = attn_lib.attention_block(
            lp["self_attn"], layernorm(lp["ln1"], x, cfg.norm_eps),
            self._positions(x), cfg.attention, causal=True,
            chunk=self.q_chunk)
        x = x + h
        kv = attn_lib.encode_kv(lp["cross_attn"], enc, cfg.attention)
        x = x + attn_lib.cross_attention_block(
            lp["cross_attn"], layernorm(lp["ln_x"], x, cfg.norm_eps), kv,
            cfg.attention)
        return x + mlp_apply(lp["mlp"], layernorm(lp["ln2"], x, cfg.norm_eps),
                             "gelu")

    def forward(self, params, tokens, extra_embeds=None, *,
                last_only: bool = False):
        """Teacher-forced train / prefill: tokens (B, S) and the encoder's
        stub frames ``extra_embeds`` (B, encoder_seq, D) ->
        (logits (B, S, V) f32, 0)."""
        cfg = self.cfg
        enc = self.encode(params, extra_embeds)
        x = embed(params["embed"], tokens)
        x = self._run_layers(self._dec_layer, x, params["dec_layers"],
                             cfg.num_layers, enc)
        if last_only:
            x = x[:, -1:]
        x = layernorm(params["final_norm"], x, cfg.norm_eps)
        return (unembed(params["head"], x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    # ---------------------------------------------------------------- decode
    def init_decode_cache(self, batch: int, max_seq: int):
        cfg = self.cfg
        a = cfg.attention
        L = cfg.num_layers
        dt, dev = self.dtype, self.device
        kv = (L, batch, max_seq, a.num_kv_heads, a.head_dim)
        xkv = (L, batch, cfg.encoder_seq, a.num_kv_heads, a.head_dim)
        return {
            "k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev),
            # cross-attention K/V, computed from the encoder at prefill
            "xk": torch.zeros(xkv, dtype=dt, device=dev),
            "xv": torch.zeros(xkv, dtype=dt, device=dev),
            "seq_lens": torch.zeros((batch,), dtype=torch.int32,
                                    device=dev),
        }

    def prefill_cross(self, params, cache, frames):
        """Encode once and fill every decoder layer's cross-attention K/V
        (IN PLACE; the cache is returned)."""
        enc = self.encode(params, frames)
        for i in range(self.cfg.num_layers):
            lp = stacking.layer(params["dec_layers"], i)
            k, v = attn_lib.encode_kv(lp["cross_attn"], enc,
                                      self.cfg.attention)
            cache["xk"][i] = k
            cache["xv"][i] = v
        return cache

    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache updated IN
        PLACE: self-attention K/V written at ``seq_lens`` and attended over
        positions <= seq_lens, cross-attention over ``xk``/``xv``."""
        cfg = self.cfg
        a = cfg.attention
        seq_lens = cache["seq_lens"]
        x = embed(params["embed"], tokens)                  # (B, D)
        for i in range(cfg.num_layers):
            lp = stacking.layer(params["dec_layers"], i)
            h = layernorm(lp["ln1"], x[:, None], cfg.norm_eps)
            ctx = decode_attention(lp["self_attn"], h, cache["k"][i],
                                   cache["v"][i], seq_lens, a)
            x = x + torch.matmul(ctx, lp["self_attn"]["wo"])
            hx = layernorm(lp["ln_x"], x[:, None], cfg.norm_eps)
            x = x + attn_lib.cross_attention_block(
                lp["cross_attn"], hx, (cache["xk"][i], cache["xv"][i]),
                a)[:, 0]
            h = mlp_apply(lp["mlp"],
                          layernorm(lp["ln2"], x[:, None], cfg.norm_eps),
                          "gelu")
            x = x + h[:, 0]
        x = layernorm(params["final_norm"], x[:, None], cfg.norm_eps)
        logits = unembed(params["head"], x)[:, 0]
        seq_lens.add_(1)
        return logits, cache

    def loss(self, params, batch):
        """Next-token CE; batch: tokens (B, S) and extra_embeds, the stub
        frames (B, encoder_seq, D)."""
        logits, _ = self.forward(params, batch["tokens"],
                                 batch.get("extra_embeds"))
        return next_token_loss(logits, batch["tokens"])
