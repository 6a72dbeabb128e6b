"""RWKV6 "Finch" LM (port of ``repro.models.rwkv6``): attention-free, so
there is no KV cache to page; serving carries a constant-size recurrent
state a request instead (:meth:`RWKV6LM.init_decode_cache`).

Parameters keep the reference's tree: ``embed``, ``ln0``, ``layers``
(``ln1``, ``ln2``, ``tm`` the time mix, ``cm`` the channel mix, stacked on
a leading ``L`` axis), ``final_norm`` and ``head``.  All of it is plain
PyTorch; the reference reaches no Pallas kernel on this path.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.layers import rwkv as rwkv_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.norm import layernorm, layernorm_init
from repro_torch.models import stacking
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class RWKV6LM:
    def __init__(self, cfg: ModelConfig, *, device="cuda", remat=True):
        self.cfg = cfg
        self.remat = remat_lib.resolve(remat)
        self.device = device_lib.resolve(device)
        self.dtype = stacking.DTYPES[cfg.dtype]

    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a seeded generator on the model's
        device, in the reference's tree, shapes and per-leaf dtypes."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)
        d = cfg.d_model
        layers = stacking.init_stacked(cfg.num_layers, lambda: {
            "ln1": layernorm_init(d, dt, dev),
            "ln2": layernorm_init(d, dt, dev),
            "tm": rwkv_lib.rwkv_time_mix_init(gen, d, cfg.rwkv, dt, dev),
            "cm": rwkv_lib.rwkv_channel_mix_init(gen, d, cfg.d_ff, dt, dev),
        })
        return {
            "embed": embedding_init(gen, cfg.vocab_size, d, dt, dev),
            "ln0": layernorm_init(d, dt, dev),
            "layers": layers,
            "final_norm": layernorm_init(d, dt, dev),
            "head": embedding_init(gen, cfg.vocab_size, d, dt, dev),
        }

    def _block(self, lp, x):
        cfg = self.cfg
        x = x + rwkv_lib.time_mix_chunked(
            lp["tm"], layernorm(lp["ln1"], x, cfg.norm_eps), cfg.rwkv)
        h, _ = rwkv_lib.channel_mix(lp["cm"],
                                    layernorm(lp["ln2"], x, cfg.norm_eps))
        return x + h

    def forward(self, params, tokens, extra_embeds=None, *,
                last_only: bool = False):
        """tokens (B, S) -> (logits (B, S, V) f32, 0).  ``extra_embeds`` is
        taken and ignored, as in the reference; S must be a multiple of
        the time mix's chunk (32) or below it."""
        cfg = self.cfg
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
    def init_decode_cache(self, batch: int, max_seq: int = 0):
        """The recurrent state of ``batch`` requests (``max_seq`` is
        unused: the state does not grow)."""
        cfg = self.cfg
        L, D = cfg.num_layers, cfg.d_model
        N = cfg.rwkv.head_size
        dt, dev = self.dtype, self.device
        return {
            "tm_shift": torch.zeros((L, batch, D), dtype=dt, device=dev),
            "cm_shift": torch.zeros((L, batch, D), dtype=dt, device=dev),
            "S": torch.zeros((L, batch, D // N, N, N), dtype=torch.float32,
                             device=dev),
            "seq_lens": torch.zeros((batch,), dtype=torch.int32,
                                    device=dev),
        }

    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V) f32, cache), the cache updated IN
        PLACE.  The time mix's shift holds the layer-normed input ``h``,
        as the reference's does."""
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

    def loss(self, params, batch):
        logits, _ = self.forward(params, batch["tokens"])
        return next_token_loss(logits, batch["tokens"])
