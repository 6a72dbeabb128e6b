"""Decoder-only transformer LM (port of the single-device paths of
``repro.models.transformer``: the dense, MoE and VLM decoders):

* :meth:`TransformerLM.forward`: prefill / loss logits over whole
  sequences (plain chunked attention), with the VLM's vision-stub
  embeddings (``extra_embeds``) prepended;
* :meth:`TransformerLM.decode_step`: one token per request over a
  contiguous K/V cache (:meth:`TransformerLM.init_decode_cache`), plain
  PyTorch, as the reference's pjit decode path;
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
the three decode paths, as the reference does.

:meth:`TransformerLM.loss` is the reference's training loss (next-token
CE over the text positions plus 0.01 times the MoE aux loss),
differentiable end to end; with grad enabled each layer of ``forward``
runs under the ``remat`` policy (``repro_torch.training.remat``: True or
``"full"``, ``"dots"``, False or ``"none"``).  Left out: ``scan_layers``
and ``unroll_attn`` (JAX compile notions: the layers are a Python loop
here); ``shard_moe`` and ``moe_groups`` (expert sharding, with multi-GPU,
A10).
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
from repro_torch.models import stacking
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class TransformerLM:
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 q_chunk: int = 512, remat=True):
        self.cfg = cfg
        self.q_chunk = q_chunk          # forward's attention query chunk
        self.remat = remat_lib.resolve(remat)
        self.device = device_lib.resolve(device)
        self.dtype = stacking.DTYPES[cfg.dtype]

    def init(self, seed: int = 0) -> Dict:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device (normal, scaled by fan-in^-0.5; norms at 1)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)

        def layer():
            return {
                "ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_lib.attention_init(gen, cfg.d_model,
                                                cfg.attention, dt, dev),
                **({"moe": moe_init(gen, cfg.d_model, cfg.moe, dt, dev)}
                   if cfg.moe is not None else
                   {"mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                                    dev)}),
            }

        layers = stacking.init_stacked(cfg.num_layers, layer)
        params = {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dt,
                                    dev),
            "layers": layers,
            "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                            dt, dev)
        return params

    def init_abstract(self) -> Dict:
        """:meth:`init`'s tree (keys, shapes, dtypes) as meta tensors,
        drawn from nothing and allocated nowhere."""
        return stacking.init_abstract(self)

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

    def _embed_inputs(self, params, tokens, extra_embeds):
        x = embed(params["embed"], tokens)
        if extra_embeds is not None:  # VLM: prepend vision-stub embeddings
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x

    def forward(self, params, tokens, extra_embeds=None, *,
                return_kv: bool = False, last_only: bool = False):
        """tokens (B, S) [+ extra_embeds (B, E, D), prepended] ->
        (logits (B, E + S, V) f32, aux) — and the layers' (k, v), each
        stacked (L, B, E + S, KV, hd), with ``return_kv``.  ``last_only``
        unembeds the last position only.  ``aux`` is the reference's MoE
        loss summed over the layers, 0 for a dense model."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens, extra_embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        ks, vs = [], []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = (remat_lib.wrap(self._block, self.remat)
                 if torch.is_grad_enabled() else self._block)
        for lp in stacking.unstack(params["layers"], cfg.num_layers):
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
        (B, S) [+ extra_embeds (B, E, D), loss_mask (B, S)], tensors on
        the model's device.  The vision positions are not scored."""
        extra = batch.get("extra_embeds")
        logits, aux = self.forward(params, batch["tokens"], extra)
        if extra is not None:
            logits = logits[:, extra.shape[1]:]
        return next_token_loss(logits, batch["tokens"],
                               batch.get("loss_mask")) + 0.01 * aux

    # ---------------------------------------------------- contiguous decode
    def init_decode_cache(self, batch: int, max_seq: int):
        """Zeroed K/V (L, batch, max_seq, KV, hd) and seq_lens (batch,)."""
        cfg = self.cfg
        a = cfg.attention
        shape = (cfg.num_layers, batch, max_seq, a.num_kv_heads, a.head_dim)
        return {
            "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            "seq_lens": torch.zeros((batch,), dtype=torch.int32,
                                    device=self.device),
        }

    def decode_step(self, params, cache, tokens):
        """tokens (B,) -> (logits (B, V) f32, cache): each layer writes the
        token's K/V at position ``seq_lens`` of its cache layer and attends
        over positions ``<= seq_lens`` (:func:`decode_attention`).  The
        cache is updated IN PLACE (the reference returns a new one) and
        returned; its ``seq_lens`` grow by one."""
        cfg = self.cfg
        seq_lens = cache["seq_lens"]
        x = embed(params["embed"], tokens)                  # (B, D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = stacking.layer(lp_all, i)
            h = rmsnorm(lp["ln1"], x[:, None], cfg.norm_eps)
            ctx = decode_attention(lp["attn"], h, cache["k"][i],
                                   cache["v"][i], seq_lens, cfg.attention)
            x = x + torch.matmul(ctx, lp["attn"]["wo"])
            h = rmsnorm(lp["ln2"], x[:, None], cfg.norm_eps)
            x = x + self._ffn(lp, h, full_capacity=True)[0][:, 0]
        x = rmsnorm(params["final_norm"], x[:, None], cfg.norm_eps)
        logits = unembed(params.get("head", params["embed"]), x)[:, 0]
        seq_lens.add_(1)
        return logits, cache

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
            lp = stacking.layer(lp_all, i)
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
            lp = stacking.layer(lp_all, i)
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



def decode_attention(params, h, k_cache, v_cache, seq_lens, a):
    """One decode token against a contiguous cache layer: h (B, 1, D) the
    normed input, k_cache / v_cache (B, S, KV, hd) written IN PLACE at
    position ``seq_lens`` (B,), then attended over positions <= seq_lens
    (the new token included; the rest masked with NEG_INF, -1e30, as the
    reference).  Returns ctx (B, H * hd)."""
    B = h.shape[0]
    q, k_new, v_new = attn_lib.project_qkv(params, h, a, seq_lens[:, None])
    rows = torch.arange(B, device=h.device)
    pos = seq_lens.long()
    k_cache[rows, pos] = k_new[:, 0]
    v_cache[rows, pos] = v_new[:, 0]
    KV = a.num_kv_heads
    qg = q[:, 0].reshape(B, KV, a.num_heads // KV, a.head_dim)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float()
    scores = scores * a.head_dim ** -0.5
    mask = (torch.arange(k_cache.shape[1], device=h.device)[None]
            <= seq_lens[:, None])
    scores = torch.where(mask[:, None, None], scores, attn_lib.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgs,bskd->bkgd", w, v_cache).reshape(B, -1)
