"""Decoder-only transformer LM (port of the dense and MoE single-device
paths of ``repro.models.transformer``):

* :meth:`TransformerLM.forward`: prefill / loss logits over whole
  sequences (plain chunked attention);
* :meth:`TransformerLM.decode_tokens_paged`: the serving engine's fused
  chunked-prefill + decode step over the fused KV pool, through the ragged
  or the chunked paged-attention kernel;
* :meth:`TransformerLM.decode_step_paged`: the paper path, one decode
  token per request over split K/V pools, through the decode-shape
  BlockList kernel.

Parameters are a dict with the JAX pytree's names and layouts: ``embed``,
``layers`` (``ln1``, ``ln2``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``},
``mlp`` {``w_gate``, ``w_up``, ``w_down``} or, for a MoE config, ``moe``
{``router``, ``w_gate``, ``w_up``, ``w_down``[, ``shared``]}, each stacked
on a leading ``L`` axis as ``jax.vmap(_layer_init)`` stacks them),
``final_norm`` and, for untied models, ``head``.  A MoE layer routes with
capacity dropping in :meth:`TransformerLM.forward` and at full capacity in
the two decode paths, as the reference does.

:meth:`TransformerLM.loss` is the reference's training loss (next-token
CE plus 0.01 times the MoE aux loss), differentiable end to end; with
grad enabled each layer of ``forward`` runs under the ``remat`` policy
(``repro_torch.training.remat``: True or ``"full"``, ``"dots"``, False or
``"none"``).  Left out: ``extra_embeds`` (the VLM stub, ROADMAP A12);
``scan_layers`` and ``unroll_attn`` (JAX compile notions: the layers are
a Python loop here); ``shard_moe`` and ``moe_groups`` (expert sharding,
with multi-GPU, A10).
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
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TransformerLM:
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 q_chunk: int = 512, remat=True):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r}: the port serves dense and MoE "
                "decoders")
        self.cfg = cfg
        self.q_chunk = q_chunk          # forward's attention query chunk
        self.remat = remat_lib.resolve(remat)
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
                **({"moe": moe_init(gen, cfg.d_model, cfg.moe, dt, dev)}
                   if cfg.moe is not None else
                   {"mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                                    dev)}),
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

    # --------------------------------------------------------------- forward
    def _ffn(self, lp, h, *, full_capacity: bool):
        """The layer's feed-forward on h (B, S, D): the SwiGLU, or the MoE
        (capacity-dropped, or at full capacity on the decode paths).
        Returns (out, aux), aux 0 for a dense layer."""
        cfg = self.cfg
        if cfg.moe is not None:
            return moe_apply(lp["moe"], h, cfg.moe,
                             full_capacity=full_capacity)
        return (mlp_apply(lp["mlp"], h, cfg.act),
                torch.zeros((), dtype=torch.float32, device=h.device))

    def _block(self, lp, x, positions):
        cfg = self.cfg
        h, kv = attn_lib.attention_block(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
            cfg.attention, chunk=self.q_chunk)
        x = x + h
        h, aux = self._ffn(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps),
                           full_capacity=False)
        return x + h, aux, kv

    def _embed_inputs(self, params, tokens):
        return embed(params["embed"], tokens)

    def forward(self, params, tokens, *, return_kv: bool = False,
                last_only: bool = False):
        """tokens (B, S) -> (logits (B, S, V) f32, aux) — and the layers'
        (k, v), each stacked (L, B, S, KV, hd), with ``return_kv``.
        ``last_only`` unembeds the last position only.  ``aux`` is the
        reference's MoE loss summed over the layers, 0 for a dense model."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        ks, vs = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = (remat_lib.wrap(self._block, self.remat)
                 if torch.is_grad_enabled() else self._block)
        for lp in _unstack(params["layers"], cfg.num_layers):
            x, layer_aux, (k, v) = block(lp, x, positions)
            aux = aux + layer_aux
            if return_kv:
                ks.append(k)
                vs.append(v)
        if last_only:
            x = x[:, -1:]
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = unembed(params.get("head", params["embed"]), x)
        if return_kv:
            return logits, aux, (torch.stack(ks), torch.stack(vs))
        return logits, aux

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch):
        """Next-token CE plus 0.01 times the MoE aux loss.  batch: tokens
        (B, S) [+ loss_mask (B, S)], tensors on the model's device."""
        logits, aux = self.forward(params, batch["tokens"])
        return next_token_loss(logits, batch["tokens"],
                               batch.get("loss_mask")) + 0.01 * aux

    # ---------------------------------------------------------------- decode
    def decode_step_paged(self, params, pools, lists, tokens, *,
                          num_lanes: Optional[int] = None):
        """Paged decode, one token per request (the paper's technique).

        pools {"k", "v"} (L, NB, BS, KV, HD), updated IN PLACE; lists:
        block_list/block_req/block_pos (Tb,) the flat BlockList keyed by
        request, seq_lens (B,) keys held before this token, slots (B, 2)
        pool (block, offset) of this token.  Each layer writes the token's
        K/V at its slot and attends through the decode kernel
        (:data:`attention_api.paged_attention_op`) over ``seq_lens + 1``
        keys.  ``num_lanes``: as in :meth:`decode_tokens_paged` (B when
        every slot is real).  Returns (logits (B, V) f32, pools).
        """
        cfg = self.cfg
        a = cfg.attention
        seq_lens = lists["seq_lens"]
        x = embed(params["embed"], tokens)                  # (B, D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = _layer(lp_all, i)
            h = rmsnorm(lp["ln1"], x[:, None], cfg.norm_eps)
            q, k_new, v_new = attn_lib.project_qkv(lp["attn"], h, a,
                                                   seq_lens[:, None])
            pk, pv = pools["k"][i], pools["v"][i]
            paged_kv.append_to_pool(pk, k_new[:, 0], lists["slots"],
                                    num_lanes)
            paged_kv.append_to_pool(pv, v_new[:, 0], lists["slots"],
                                    num_lanes)
            ctx = attention_api.paged_attention_op(
                q[:, 0].contiguous(), pk, pv, lists["block_list"],
                lists["block_req"], lists["block_pos"], seq_lens + 1)
            x = x + torch.matmul(ctx.reshape(x.shape[0], -1),
                                 lp["attn"]["wo"])
            h = rmsnorm(lp["ln2"], x[:, None], cfg.norm_eps)
            x = x + self._ffn(lp, h, full_capacity=True)[0][:, 0]
        x = rmsnorm(params["final_norm"], x[:, None], cfg.norm_eps)
        head = params.get("head", params["embed"])
        return unembed(head, x)[:, 0], pools

    def decode_tokens_paged(self, params, pools, lists, tokens, *,
                            num_lanes: Optional[int] = None,
                            attn_impl: str = "ragged", q_chunk: int = 16,
                            prefetch_depth: int = 0,
                            attn_tunables: Optional[Dict[str, int]] = None):
        """Fused chunked-prefill + decode over flat token lanes.

        Per layer each lane's K/V is written into the fused pool
        ``pools["kv"]`` (L, NB, BS, 2*KV, HD) — IN PLACE, where JAX returns
        a new pool — and every lane attends through the op ``attn_impl``
        picks: ``"ragged"`` the ragged kernel on the fused pool and the cu
        prefix sums, ``"chunked"`` the chunked kernel on split views of the
        same pool and the per-lane ``token_req``/``token_pos``/``kv_lens``
        (tuned by ``q_chunk`` and ``prefetch_depth``).  ``attn_tunables``
        (the ragged family's keys; None: the defaults) go to the ragged
        kernel, their split and cap to the chunked one.  Greedy outputs are
        identical either way at an equal split.

        lists (as the engine renders them): block_list/block_req/block_pos
        (Tb,), kv_lens (B,), token_req/token_pos (T,),
        cu_q_lens/cu_kv_lens (S+1,), seq_slot (S,),
        slots (T, 2) pool (block, offset) per lane — (NB, 0) for padding
        lanes, whose writes are dropped — last_lane (B,) and, on a
        speculative verify step, logit_lanes (B, R): the lanes to unembed
        per slot (its last committed token and its drafts).
        ``num_lanes`` is the count of real lanes (``cu_q_lens[-1]``) when
        the caller has it on the host; the pool writes then need no mask
        (see :func:`paged_kv.append_to_pool`).

        Returns (logits (B, V) f32 at each slot's last lane, or (B, R, V)
        at ``logit_lanes`` when present, pools).
        """
        if attn_impl not in ("ragged", "chunked"):
            raise ValueError(
                f"attn_impl {attn_impl!r}: expected 'ragged' or 'chunked'")
        cfg = self.cfg
        a = cfg.attention
        pool = pools["kv"]
        token_pos = lists["token_pos"]
        tun = dict(attn_tunables or {})
        split_kw = {k: tun[k] for k in ("num_kv_pages_per_block",
                                        "vmem_limit_bytes") if k in tun}
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
            if attn_impl == "ragged":
                ctx = attention_api.paged_attention_ragged_op(
                    q[:, 0].contiguous(), pool[i], lists["block_list"],
                    lists["block_req"], lists["block_pos"],
                    lists["cu_q_lens"], lists["cu_kv_lens"],
                    lists["seq_slot"], **tun)
            else:
                pk, pv = paged_kv.fused_kv_views(pool[i])
                ctx = attention_api.paged_attention_chunked_op(
                    q[:, 0].contiguous(), pk, pv, lists["block_list"],
                    lists["block_req"], lists["block_pos"],
                    lists["kv_lens"], lists["token_req"], token_pos,
                    q_chunk=q_chunk, prefetch_depth=prefetch_depth,
                    **split_kw)
            x = x + torch.matmul(ctx.reshape(x.shape[0], -1),
                                 lp["attn"]["wo"])
            h = rmsnorm(lp["ln2"], x[:, None], cfg.norm_eps)
            x = x + self._ffn(lp, h, full_capacity=True)[0][:, 0]
        head = params.get("head", params["embed"])
        if "logit_lanes" in lists:
            x_sel = x[lists["logit_lanes"].long()]          # (B, R, D)
            x_sel = rmsnorm(params["final_norm"], x_sel, cfg.norm_eps)
            return unembed(head, x_sel), pools
        x_last = x[lists["last_lane"].long()]
        x_last = rmsnorm(params["final_norm"], x_last[:, None], cfg.norm_eps)
        return unembed(head, x_last)[:, 0], pools


def _stack(layers):
    """List of per-layer dicts -> one dict of ``L``-stacked tensors."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return torch.stack(layers)


def _unstack(tree, n: int):
    """An ``L``-stacked parameter dict -> ``n`` per-layer dicts, each leaf
    split once with ``unbind``: its gradient is one stack of the layers'
    gradients, where a view per layer would add each layer's gradient
    into a zeroed copy of the whole stacked leaf (L times its bytes)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def _layer(tree, i: int):
    """Layer ``i`` of an ``L``-stacked parameter dict (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
