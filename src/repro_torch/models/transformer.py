"""Decoder-only transformer LM for serving (port of the dense, single-device
``decode_tokens_paged`` path of ``repro.models.transformer``).

Parameters are a dict with the JAX pytree's names and layouts: ``embed``,
``layers`` (``ln1``, ``ln2``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``},
``mlp`` {``w_gate``, ``w_up``, ``w_down``}, each stacked on a leading
``L`` axis as ``jax.vmap(_layer_init)`` stacks them), ``final_norm`` and,
for untied models, ``head``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.core import attention_api, paged_kv
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.mlp import mlp_apply, mlp_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TransformerLM:
    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r}: the port serves dense decoders")
        self.cfg = cfg
        self.device = device_lib.resolve(device)
        self.dtype = _DTYPES[cfg.dtype]

    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device (normal, scaled by fan-in^-0.5; norms at 1)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        layers = []
        for _ in range(cfg.num_layers):
            layers.append({
                "ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_lib.attention_init(gen, cfg.d_model,
                                                cfg.attention, dt, dev),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt, dev),
            })
        params = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                    dev),
            "layers": _stack(layers),
            "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                            dt, dev)
        return params

    def decode_tokens_paged(self, params, pools, lists, tokens, *,
                            num_lanes: Optional[int] = None):
        """Fused chunked-prefill + decode over flat token lanes.

        Per layer each lane's K/V is written into the fused pool
        ``pools["kv"]`` (L, NB, BS, 2*KV, HD) — IN PLACE, where JAX returns
        a new pool — and every lane attends through the ragged op.

        lists (as the engine renders them): block_list/block_req/block_pos
        (Tb,), token_pos (T,), cu_q_lens/cu_kv_lens (S+1,), seq_slot (S,),
        slots (T, 2) pool (block, offset) per lane — (NB, 0) for padding
        lanes, whose writes are dropped — and last_lane (B,).
        ``num_lanes`` is the count of real lanes (``cu_q_lens[-1]``) when
        the caller has it on the host; the pool writes then need no mask
        (see :func:`paged_kv.append_to_pool`).

        Returns (logits (B, V) f32 at each slot's last lane, pools).
        """
        cfg = self.cfg
        a = cfg.attention
        pool = pools["kv"]
        token_pos = lists["token_pos"]
        x = embed(params["embed"], tokens)                  # (T, D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = _layer(lp_all, i)
            h = rmsnorm(lp["ln1"], x[:, None], cfg.norm_eps)
            q, k_new, v_new = attn_lib.project_qkv(lp["attn"], h, a,
                                                   token_pos[:, None])
            paged_kv.append_to_pool(
                pool[i], paged_kv.fuse_kv_heads(k_new[:, 0], v_new[:, 0]),
                lists["slots"], num_lanes)
            ctx = attention_api.paged_attention_ragged_op(
                q[:, 0].contiguous(), pool[i], lists["block_list"],
                lists["block_req"], lists["block_pos"], lists["cu_q_lens"],
                lists["cu_kv_lens"], lists["seq_slot"])
            x = x + torch.matmul(ctx.reshape(x.shape[0], -1),
                                 lp["attn"]["wo"])
            h = rmsnorm(lp["ln2"], x[:, None], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h, cfg.act)[:, 0]
        x_last = x[lists["last_lane"].long()]
        x_last = rmsnorm(params["final_norm"], x_last[:, None], cfg.norm_eps)
        head = params.get("head", params["embed"])
        return unembed(head, x_last)[:, 0], pools


def _stack(layers):
    """List of per-layer dicts -> one dict of ``L``-stacked tensors."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return torch.stack(layers)


def _layer(tree, i: int):
    """Layer ``i`` of an ``L``-stacked parameter dict (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
