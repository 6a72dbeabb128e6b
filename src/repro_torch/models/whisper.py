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

On a ``(data, model)`` mesh (``mesh=`` on :meth:`WhisperEncDec.forward`,
:meth:`WhisperEncDec.loss`, :meth:`WhisperEncDec.prefill_cross` and
:meth:`WhisperEncDec.decode_step`; ``models.mesh_lm`` for the rules and
the shards): leaves gathered over ``data`` (FSDP), the encoder's and the
decoder's attention split on whole heads and the GELU MLP column / row
parallel where the rules split them (whisper-tiny's 6 heads stay whole on
4 ranks, its 51865-row vocabulary on any even axis: those run whole), the
self-attention cache and the cross K/V (``xk`` / ``xv``, 1500 frames)
sequence-sharded, each rank attending over its block and the partials
combined (``core.attention_api.combine_partials``).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.mlp import mlp_apply, mlp_apply_mesh, mlp_init
from repro_torch.layers.norm import layernorm, layernorm_init
from repro_torch.models import stacking
from repro_torch.models.mesh_lm import MeshLM, alloc_cache, cut_tree, seq_split
from repro_torch.models.transformer import attend_partial, decode_attention
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class WhisperEncDec(MeshLM):
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 q_chunk: int = 512, remat=True):
        self.cfg = cfg
        self.q_chunk = q_chunk
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
        d, a = cfg.d_model, cfg.attention
        enc = stacking.init_stacked(cfg.encoder_layers, lambda: cut_tree(
            shard, ("enc_layers",), {
                "ln1": layernorm_init(d, dt, dev),
                "attn": attn_lib.attention_init(gen, d, a, dt, dev),
                "ln2": layernorm_init(d, dt, dev),
                "mlp": mlp_init(gen, d, cfg.d_ff, "gelu", dt, dev)}))
        dec = stacking.init_stacked(cfg.num_layers, lambda: cut_tree(
            shard, ("dec_layers",), {
                "ln1": layernorm_init(d, dt, dev),
                "self_attn": attn_lib.attention_init(gen, d, a, dt, dev),
                "ln_x": layernorm_init(d, dt, dev),
                "cross_attn": attn_lib.attention_init(gen, d, a, dt, dev),
                "ln2": layernorm_init(d, dt, dev),
                "mlp": mlp_init(gen, d, cfg.d_ff, "gelu", dt, dev)}))

        def top(name, tree):
            return cut_tree(shard, (name,), tree)

        return {
            "embed": top("embed", embedding_init(gen, cfg.vocab_size, d, dt,
                                                 dev)),
            "enc_layers": enc,
            "enc_norm": top("enc_norm", layernorm_init(d, dt, dev)),
            "dec_layers": dec,
            "final_norm": top("final_norm", layernorm_init(d, dt, dev)),
            "head": top("head", embedding_init(gen, cfg.vocab_size, d, dt,
                                               dev)),
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

    # ------------------------------------------------------------ on a mesh
    def _enc_layer_mesh(self, lp, x, tp):
        cfg = self.cfg
        lp = tp.gather_params(lp, "enc_layers")
        x = x + attn_lib.attention_block_tp(
            lp["attn"], layernorm(lp["ln1"], x, cfg.norm_eps),
            self._positions(x), cfg.attention, tp, causal=False,
            chunk=self.q_chunk, path=("enc_layers", "attn"))
        return x + mlp_apply_mesh(lp["mlp"],
                                  layernorm(lp["ln2"], x, cfg.norm_eps),
                                  "gelu", tp, ("enc_layers", "mlp"))

    def _dec_layer_mesh(self, lp, x, enc, tp):
        cfg = self.cfg
        lp = tp.gather_params(lp, "dec_layers")
        x = x + attn_lib.attention_block_tp(
            lp["self_attn"], layernorm(lp["ln1"], x, cfg.norm_eps),
            self._positions(x), cfg.attention, tp, causal=True,
            chunk=self.q_chunk, path=("dec_layers", "self_attn"))
        x = x + attn_lib.cross_attention_block_tp(
            lp["cross_attn"], layernorm(lp["ln_x"], x, cfg.norm_eps), enc,
            cfg.attention, tp, ("dec_layers", "cross_attn"))
        return x + mlp_apply_mesh(lp["mlp"],
                                  layernorm(lp["ln2"], x, cfg.norm_eps),
                                  "gelu", tp, ("dec_layers", "mlp"))

    def _encode_mesh(self, params, top, frames, tp):
        x = self._run_layers(functools.partial(self._enc_layer_mesh, tp=tp),
                             frames.to(self.dtype), params["enc_layers"],
                             self.cfg.encoder_layers)
        return layernorm(top["enc_norm"], x, self.cfg.norm_eps)

    def _hidden_mesh(self, params, tokens, frames, mesh):
        tp = self.tensor_parallel(mesh)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k not in ("enc_layers", "dec_layers")})
        enc = self._encode_mesh(params, top, frames, tp)
        x = self._run_layers(functools.partial(self._dec_layer_mesh, tp=tp),
                             self._embed_tp(top, tokens, tp),
                             params["dec_layers"], self.cfg.num_layers, enc)
        return layernorm(top["final_norm"], x, self.cfg.norm_eps), top, tp

    def forward(self, params, tokens, extra_embeds=None, *,
                last_only: bool = False, mesh=None):
        """Teacher-forced train / prefill: tokens (B, S) and the encoder's
        stub frames ``extra_embeds`` (B, encoder_seq, D) ->
        (logits (B, S, V) f32, 0).  ``mesh``: params this rank's shards,
        tokens and frames its batch shard; its logits come back whole over
        ``model``."""
        cfg = self.cfg
        if mesh is not None:
            x, top, tp = self._hidden_mesh(params, tokens, extra_embeds,
                                           mesh)
            if last_only:
                x = x[:, -1:]
            return (self._logits_mesh(top, x, tp),
                    torch.zeros((), dtype=torch.float32, device=x.device))
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
    def init_decode_cache(self, batch: int, max_seq: int, *, mesh=None):
        """The self-attention K/V (L, batch, max_seq, KV, hd), the
        cross-attention K/V (L, batch, encoder_seq, KV, hd) and seq_lens;
        with ``mesh``, this rank's shard of them (``cache_spec``: both
        sequences over ``model``)."""
        cfg = self.cfg
        a = cfg.attention
        L = cfg.num_layers
        dt = self.dtype
        kv = (L, batch, max_seq, a.num_kv_heads, a.head_dim)
        xkv = (L, batch, cfg.encoder_seq, a.num_kv_heads, a.head_dim)
        return alloc_cache(
            {"k": (kv, dt), "v": (kv, dt),
             # cross-attention K/V, computed from the encoder at prefill
             "xk": (xkv, dt), "xv": (xkv, dt),
             "seq_lens": ((batch,), torch.int32)}, self.device,
            self.sharding_rules(mesh) if mesh is not None else None, mesh)

    def prefill_cross(self, params, cache, frames, *, mesh=None):
        """Encode once and fill every decoder layer's cross-attention K/V
        (IN PLACE; the cache is returned).  ``mesh``: params this rank's
        shards, frames its batch shard, the cache its shard: each rank
        writes its block of the frames' K/V (every head)."""
        if mesh is not None:
            return self._prefill_cross_mesh(params, cache, frames, mesh)
        enc = self.encode(params, frames)
        for i in range(self.cfg.num_layers):
            lp = stacking.layer(params["dec_layers"], i)
            k, v = attn_lib.encode_kv(lp["cross_attn"], enc,
                                      self.cfg.attention)
            cache["xk"][i] = k
            cache["xv"][i] = v
        return cache

    def _prefill_cross_mesh(self, params, cache, frames, mesh):
        cfg = self.cfg
        a = cfg.attention
        tp = self.tensor_parallel(mesh)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k not in ("enc_layers", "dec_layers")})
        enc = self._encode_mesh(params, top, frames, tp)
        B, S = enc.shape[0], cache["xk"].shape[2]
        lo = tp.rank * S if S != cfg.encoder_seq else 0
        path = ("dec_layers", "cross_attn")
        for i in range(cfg.num_layers):
            lp = tp.gather_params(stacking.layer(params["dec_layers"], i),
                                  "dec_layers")["cross_attn"]
            # every frame through the rank's heads, the heads gathered,
            # then the rank's block of frames kept
            k = torch.matmul(enc, lp["wk"])
            v = torch.matmul(enc, lp["wv"])
            if tp.split(*path, "wk"):
                k, v = tp.gather_last([k, v])
            if "bk" in lp:
                k, v = k + lp["bk"], v + lp["bv"]
            cache["xk"][i] = k[:, lo:lo + S].reshape(B, S, a.num_kv_heads,
                                                     a.head_dim)
            cache["xv"][i] = v[:, lo:lo + S].reshape(B, S, a.num_kv_heads,
                                                     a.head_dim)
        return cache

    def decode_step(self, params, cache, tokens, *, mesh=None,
                    max_seq: Optional[int] = None):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache updated IN
        PLACE: self-attention K/V written at ``seq_lens`` and attended over
        positions <= seq_lens, cross-attention over ``xk``/``xv``.
        ``mesh``: params, tokens and the cache this rank's shards (module
        docstring), ``max_seq`` the whole self-attention cache's length."""
        if mesh is not None:
            return self._decode_step_mesh(params, cache, tokens, mesh,
                                          max_seq)
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

    def _out(self, x, ctx, wo, tp, path):
        if tp.split(*path, "wo"):
            return x + attn_lib.out_proj_tp(ctx, wo, tp)
        return x + torch.matmul(ctx, wo)

    def _cross_step_mesh(self, params, hx, xk, xv, tp, path):
        """Cross-attention of one token (hx (B, 1, D)) over this rank's
        block of the frames' K/V (every frame when the rules leave them
        whole), the partials combined over the axis.  Returns ctx
        (B, H * hd)."""
        a = self.cfg.attention
        B = hx.shape[0]
        q = torch.matmul(hx[:, 0], params["wq"])
        if tp.split(*path, "wq"):
            q = tp.gather(q, -1)
        if "bq" in params:
            q = q + params["bq"]
        KV = a.num_kv_heads
        qg = q.reshape(B, KV, a.num_heads // KV, a.head_dim)
        scores = torch.einsum("bkgd,bskd->bkgs", qg, xk).float()
        scores = scores * a.head_dim ** -0.5
        if xk.shape[1] == self.cfg.encoder_seq:
            w = torch.softmax(scores, dim=-1).to(xv.dtype)
            return torch.einsum("bkgs,bskd->bkgd", w, xv).reshape(B, -1)
        valid = torch.ones((1, 1, 1, xk.shape[1]), dtype=torch.bool,
                           device=xk.device)
        return attend_partial(scores, valid, xv, tp).reshape(B, -1).to(
            hx.dtype)

    def _decode_step_mesh(self, params, cache, tokens, mesh, max_seq):
        cfg = self.cfg
        a = cfg.attention
        tp = self.tensor_parallel(mesh)
        split = seq_split(tp, max_seq)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k not in ("enc_layers", "dec_layers")})
        seq_lens = cache["seq_lens"]
        x = self._embed_tp(top, tokens, tp)                 # (B, D)
        for i in range(cfg.num_layers):
            lp = tp.gather_params(stacking.layer(params["dec_layers"], i),
                                  "dec_layers")
            h = layernorm(lp["ln1"], x[:, None], cfg.norm_eps)
            ctx = decode_attention(lp["self_attn"], h, cache["k"][i],
                                   cache["v"][i], seq_lens, a, tp=tp,
                                   path=("dec_layers", "self_attn"),
                                   seq_split=split)
            x = self._out(x, ctx, lp["self_attn"]["wo"], tp,
                          ("dec_layers", "self_attn"))
            hx = layernorm(lp["ln_x"], x[:, None], cfg.norm_eps)
            path = ("dec_layers", "cross_attn")
            ctx = self._cross_step_mesh(lp["cross_attn"], hx, cache["xk"][i],
                                        cache["xv"][i], tp, path)
            x = self._out(x, ctx, lp["cross_attn"]["wo"], tp, path)
            h = layernorm(lp["ln2"], x[:, None], cfg.norm_eps)
            x = x + mlp_apply_mesh(lp["mlp"], h, "gelu", tp,
                                   ("dec_layers", "mlp"))[:, 0]
        x = layernorm(top["final_norm"], x[:, None], cfg.norm_eps)
        logits = self._unembed_tp(top, x, tp)[:, 0]
        seq_lens.add_(1)
        return logits, cache

    def loss(self, params, batch, *, mesh=None):
        """Next-token CE; batch: tokens (B, S) and extra_embeds, the stub
        frames (B, encoder_seq, D).  ``mesh``: params this rank's shards
        and batch its shard of the batch; the global loss on every rank."""
        if mesh is not None:
            x, top, tp = self._hidden_mesh(params, batch["tokens"],
                                           batch.get("extra_embeds"), mesh)
            return self._ce_mesh(top, x, batch["tokens"], None, tp)
        logits, _ = self.forward(params, batch["tokens"],
                                 batch.get("extra_embeds"))
        return next_token_loss(logits, batch["tokens"])
