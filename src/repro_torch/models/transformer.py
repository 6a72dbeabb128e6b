"""Decoder-only transformer LM (port of the single-device paths of
``repro.models.transformer``: the dense, MoE and VLM decoders):

* :meth:`TransformerLM.forward`: prefill / loss logits over whole
  sequences (plain chunked attention), with the VLM's vision-stub
  embeddings (``extra_embeds``) prepended;
* :meth:`TransformerLM.decode_step`: one token per request over a
  contiguous K/V cache (:meth:`TransformerLM.init_decode_cache`), plain
  PyTorch, as the reference's pjit decode path; on a mesh (``mesh=``) the
  cache is this rank's shard, its sequence split over ``model``
  (:func:`decode_attention`: each rank's partial, combined);
* :meth:`TransformerLM.decode_tokens_paged`: the serving engine's fused
  chunked-prefill + decode step over the fused KV pool, through the ragged
  or the chunked paged-attention kernel;
* :meth:`TransformerLM.decode_step_paged`: the paper path, one decode
  token per request over split K/V pools, through the decode-shape
  BlockList kernel.

Both paged paths also run on a mesh of ranks (``mesh=``, the
mesh-native serving path of the reference): the params are this rank's
shard (:meth:`TransformerLM.shard_params`, the reference's
``ShardingRules`` with ``head_dim``), the pool this rank's block of the
sequence-sharded pool, and the BlockList this rank's LOCAL one.  Each
layer gathers the heads of a split ``wq``/``wk``/``wv``, appends the lanes
whose blocks this rank holds, takes the attention partials of its keys
from the kernel (its ``(m, l)`` statistics beside the output) and
log-sum-exp-combines them over the axis; ``wo`` and ``w_down`` are
row-parallel (a float32 SUM), the embedding and the head
vocabulary-parallel.  A weight the rules leave whole is applied whole.
A MoE layer runs expert-parallel there (``layers.moe``, at full
capacity: each rank its experts over every lane, one float32 SUM).

Training on a ``(data, model)`` mesh (:meth:`TransformerLM.loss` and
:meth:`TransformerLM.forward` with ``mesh=``): params are this rank's
shards, the batch its shard of the batch.  Each layer gathers the leaves
the data axis splits (FSDP; their gradients reduce-scattered back), runs
attention and the SwiGLU with Megatron's split over ``model``, the MoE
with its experts split over ``model`` (``shard_moe``, ``moe_groups`` as
the reference's), the embedding and the head vocabulary-parallel, and the
loss is the global mean: the rank's sum over the global token count,
summed over the data axes.  Every collective there has its conjugate
backward (``distributed.collectives``).

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
here).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.config import ModelConfig
from repro_torch.core import attention_api, paged_kv
from repro_torch.distributed.act_sharding import constrain_batch
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed, embedding_init, unembed
from repro_torch.layers.mlp import mlp_apply, mlp_apply_mesh, mlp_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init
from repro_torch.models import stacking
from repro_torch.models.mesh_lm import MeshLM, alloc_cache, seq_split
from repro_torch.perf import spans
from repro_torch.training import remat as remat_lib
from repro_torch.training.losses import next_token_loss


class TransformerLM(MeshLM):
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 q_chunk: int = 512, remat=True, shard_moe: bool = False,
                 moe_groups: int = 1):
        self.cfg = cfg
        self.q_chunk = q_chunk          # forward's attention query chunk
        self.shard_moe = shard_moe      # the reference's EP layout hint
        self.moe_groups = moe_groups    # MoE dispatch groups
        self.remat = remat_lib.resolve(remat)
        self.device = device_lib.resolve(device)
        self.dtype = stacking.DTYPES[cfg.dtype]

    def init(self, seed: int = 0, shard=None) -> Dict:
        """Random parameters from a seeded ``torch.Generator`` on the
        model's device (normal, scaled by fan-in^-0.5; norms at 1).

        ``shard``: ``fn(path, leaf) -> leaf`` applied to each leaf as soon
        as it is drawn (a layer's leaves before they are stacked), so a
        rank keeps only its shard of the same values (``shard_fn``):
        the whole tree is never held at once."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = stacking.generator(seed, dev)
        cut = shard or (lambda path, t: t)

        def cut_tree(prefix, tree):
            if isinstance(tree, dict):
                return {k: cut_tree(prefix + (k,), v)
                        for k, v in tree.items()}
            return cut(prefix, tree)

        def layer():
            return cut_tree(("layers",), {
                "ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_lib.attention_init(gen, cfg.d_model,
                                                cfg.attention, dt, dev),
                **({"moe": moe_init(gen, cfg.d_model, cfg.moe, dt, dev)}
                   if cfg.moe is not None else
                   {"mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                                    dev)}),
            })

        layers = stacking.init_stacked(cfg.num_layers, layer)
        params = {
            "embed": cut_tree(("embed",), embedding_init(
                gen, cfg.vocab_size, cfg.d_model, dt, dev)),
            "layers": layers,
            "final_norm": cut_tree(("final_norm",), rmsnorm_init(
                cfg.d_model, dt, dev)),
        }
        if not cfg.tie_embeddings:
            params["head"] = cut_tree(("head",), embedding_init(
                gen, cfg.vocab_size, cfg.d_model, dt, dev))
        return params

    def init_abstract(self) -> Dict:
        """:meth:`init`'s tree (keys, shapes, dtypes) as meta tensors,
        drawn from nothing and allocated nowhere."""
        return stacking.init_abstract(self)

    # ------------------------------------------------------------------ mesh
    def _ffn_tp(self, lp, h, tp, *, full_capacity: bool):
        """The layer's feed-forward on h (B, S, D) on a mesh: the SwiGLU
        split where the rules split it, or the MoE expert-parallel.
        Returns (out, aux)."""
        cfg = self.cfg
        if cfg.moe is not None:
            return moe_apply(lp["moe"], h, cfg.moe, shard=self.shard_moe,
                             full_capacity=full_capacity,
                             groups=self.moe_groups, tp=tp)
        return (mlp_apply_mesh(lp["mlp"], h, cfg.act, tp, ("layers", "mlp")),
                torch.zeros((), dtype=torch.float32, device=h.device))

    def _layer_tail_tp(self, lp, x, ctx, tp):
        """x + wo(ctx), then + the FFN, each split where the rules split
        it."""
        cfg = self.cfg
        ctx = ctx.reshape(x.shape[0], -1)
        if tp.split("layers", "attn", "wo"):
            x = x + attn_lib.out_proj_tp(ctx, lp["attn"]["wo"], tp)
        else:
            x = x + torch.matmul(ctx, lp["attn"]["wo"])
        h = rmsnorm(lp["ln2"], x[:, None], cfg.norm_eps)
        return x + self._ffn_tp(lp, h, tp, full_capacity=True)[0][:, 0]

    def _block_mesh(self, lp, x, positions, tp):
        """A layer on a training mesh: ``lp`` this rank's shards of it."""
        cfg = self.cfg
        lp = tp.gather_params(lp, "layers")
        x = constrain_batch(x)
        x = x + attn_lib.attention_block_tp(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), positions,
            cfg.attention, tp, chunk=self.q_chunk)
        h, aux = self._ffn_tp(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps), tp,
                              full_capacity=False)
        return x + h, aux

    def _hidden_mesh(self, params, tokens, extra_embeds, mesh):
        """The training forward on a mesh up to the final norm: (x (B, E +
        S, D), aux, the top-level params gathered over the data axis,
        the ``TensorParallel``)."""
        cfg = self.cfg
        tp = self.tensor_parallel(mesh)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k != "layers"})
        x = self._embed_tp(top, tokens, tp)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = functools.partial(self._block_mesh, tp=tp)
        if torch.is_grad_enabled():
            block = remat_lib.wrap(block, self.remat)
        for lp in stacking.unstack(params["layers"], cfg.num_layers):
            x, layer_aux = block(lp, x, positions)
            aux = aux + layer_aux
        return rmsnorm(top["final_norm"], x, cfg.norm_eps), aux, top, tp

    # --------------------------------------------------------------- forward
    def _ffn(self, lp, h, *, full_capacity: bool):
        """The layer's feed-forward on h (B, S, D): the SwiGLU, or the MoE
        (capacity-dropped, or at full capacity on the decode paths).
        Returns (out, aux), aux 0 for a dense layer."""
        cfg = self.cfg
        if cfg.moe is not None:
            return moe_apply(lp["moe"], h, cfg.moe, shard=self.shard_moe,
                             full_capacity=full_capacity,
                             groups=self.moe_groups)
        return (mlp_apply(lp["mlp"], h, cfg.act),
                torch.zeros((), dtype=torch.float32, device=h.device))

    def _block(self, lp, x, positions):
        cfg = self.cfg
        x = constrain_batch(x)
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
                return_kv: bool = False, last_only: bool = False,
                mesh=None):
        """tokens (B, S) [+ extra_embeds (B, E, D), prepended] ->
        (logits (B, E + S, V) f32, aux) — and the layers' (k, v), each
        stacked (L, B, E + S, KV, hd), with ``return_kv``.  ``last_only``
        unembeds the last position only.  ``aux`` is the reference's MoE
        loss summed over the layers, 0 for a dense model.

        ``mesh``: the training forward on a mesh (module docstring):
        params this rank's shards, tokens its batch shard; the logits of
        its batch shard come back whole (gathered over ``model``), aux the
        global one.  ``return_kv`` is not taken there."""
        cfg = self.cfg
        if mesh is not None:
            if return_kv:
                raise ValueError("forward(mesh=...) returns no K/V")
            x, aux, top, tp = self._hidden_mesh(params, tokens,
                                                extra_embeds, mesh)
            if last_only:
                x = x[:, -1:]
            return self._logits_mesh(top, x, tp), aux
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
    def loss(self, params, batch, *, mesh=None):
        """Next-token CE plus 0.01 times the MoE aux loss.  batch: tokens
        (B, S) [+ extra_embeds (B, E, D), loss_mask (B, S)], tensors on
        the model's device.  The vision positions are not scored.

        ``mesh``: params this rank's shards and batch its shard of the
        batch; the loss is the global one on every rank: the rank's CE sum
        over the global count (vocabulary-parallel where the head is
        split, no logits gathered), summed over the data axes."""
        extra = batch.get("extra_embeds")
        if mesh is not None:
            return self._loss_mesh(params, batch, mesh)
        logits, aux = self.forward(params, batch["tokens"], extra)
        if extra is not None:
            logits = logits[:, extra.shape[1]:]
        return next_token_loss(logits, batch["tokens"],
                               batch.get("loss_mask")) + 0.01 * aux

    def _loss_mesh(self, params, batch, mesh):
        tokens, extra = batch["tokens"], batch.get("extra_embeds")
        x, aux, top, tp = self._hidden_mesh(params, tokens, extra, mesh)
        if extra is not None:
            x = x[:, extra.shape[1]:]
        return (self._ce_mesh(top, x, tokens, batch.get("loss_mask"), tp)
                + 0.01 * aux)

    # ---------------------------------------------------- contiguous decode
    def init_decode_cache(self, batch: int, max_seq: int, *, mesh=None):
        """Zeroed K/V (L, batch, max_seq, KV, hd) and seq_lens (batch,);
        with ``mesh``, this rank's shard of them only (``cache_spec``: B
        over the data axes, the sequence over ``model``)."""
        cfg = self.cfg
        a = cfg.attention
        shape = (cfg.num_layers, batch, max_seq, a.num_kv_heads, a.head_dim)
        return alloc_cache(
            {"k": (shape, self.dtype), "v": (shape, self.dtype),
             "seq_lens": ((batch,), torch.int32)}, self.device,
            self.sharding_rules(mesh) if mesh is not None else None, mesh)

    def decode_step(self, params, cache, tokens, *, mesh=None,
                    max_seq: Optional[int] = None):
        """tokens (B,) -> (logits (B, V) f32, cache): each layer writes the
        token's K/V at position ``seq_lens`` of its cache layer and attends
        over positions ``<= seq_lens`` (:func:`decode_attention`).  The
        cache is updated IN PLACE (the reference returns a new one) and
        returned; its ``seq_lens`` grow by one.

        ``mesh``: the reference's sharded decode step on this rank: params
        its shards (FSDP leaves gathered a layer at a time), tokens and the
        cache its shard of them (``init_decode_cache(mesh=)``; the
        sequence split over ``model`` where ``max_seq``, the whole cache's
        length, divides), the attention sequence-sharded
        (:func:`decode_attention`), ``wo`` and the FFN split as the rules
        split them, the MoE expert-parallel at full capacity; the logits
        of its batch shard come back whole."""
        if mesh is not None:
            return self._decode_step_mesh(params, cache, tokens, mesh,
                                          max_seq)
        cfg = self.cfg
        seq_lens = cache["seq_lens"]
        x = embed(params["embed"], tokens)                  # (B, D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = stacking.layer(lp_all, i)
            x = constrain_batch(x)
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

    def _decode_step_mesh(self, params, cache, tokens, mesh, max_seq):
        cfg = self.cfg
        tp = self.tensor_parallel(mesh)
        split = seq_split(tp, max_seq)
        top = tp.gather_params({k: v for k, v in params.items()
                                if k != "layers"})
        seq_lens = cache["seq_lens"]
        x = self._embed_tp(top, tokens, tp)                 # (B, D)
        for i in range(cfg.num_layers):
            lp = tp.gather_params(stacking.layer(params["layers"], i),
                                  "layers")
            h = rmsnorm(lp["ln1"], x[:, None], cfg.norm_eps)
            ctx = decode_attention(lp["attn"], h, cache["k"][i],
                                   cache["v"][i], seq_lens, cfg.attention,
                                   tp=tp, seq_split=split)
            x = self._layer_tail_tp(lp, x, ctx, tp)
        x = rmsnorm(top["final_norm"], x[:, None], cfg.norm_eps)
        logits = self._unembed_tp(top, x, tp)[:, 0]
        seq_lens.add_(1)
        return logits, cache

    # ---------------------------------------------------------------- decode
    def decode_step_paged(self, params, pools, lists, tokens, *,
                          num_lanes: Optional[int] = None, mesh=None,
                          axis: str = "model"):
        """Paged decode, one token per request (the paper's technique).

        pools {"k", "v"} (L, NB, BS, KV, HD), updated IN PLACE; lists:
        block_list/block_req/block_pos (Tb,) the flat BlockList keyed by
        request, seq_lens (B,) keys held before this token, slots (B, 2)
        pool (block, offset) of this token.  Each layer writes the token's
        K/V at its slot and attends through the decode kernel
        (:data:`attention_api.paged_attention_op`) over ``seq_lens + 1``
        keys.  ``num_lanes``: as in :meth:`decode_tokens_paged` (B when
        every slot is real).  Returns (logits (B, V) f32, pools).

        ``mesh``: the sharded paper path (module docstring): params this
        rank's shard, pools its (L, NB / S, ...) block, block_* its LOCAL
        BlockList, and ``own_lanes`` / ``own_slots`` the requests whose
        token's block it holds, at local slots; attention through
        :func:`attention_api.paged_attention_sharded` (the decode kernel's
        partials, combined over ``axis``).
        """
        if mesh is not None:
            return self._decode_step_sharded(params, pools, lists, tokens,
                                             mesh, axis)
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

    def _decode_step_sharded(self, params, pools, lists, tokens, mesh,
                             axis):
        cfg = self.cfg
        a = cfg.attention
        tp = self.tensor_parallel(mesh, axis)
        seq_lens = lists["seq_lens"]
        x = self._embed_tp(params, tokens, tp)              # (B, D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = stacking.layer(lp_all, i)
            h = rmsnorm(lp["ln1"], x[:, None], cfg.norm_eps)
            q, k_new, v_new = attn_lib.project_qkv(lp["attn"], h, a,
                                                   seq_lens[:, None], tp)
            pk, pv = pools["k"][i], pools["v"][i]
            paged_kv.append_lanes(pk, k_new[:, 0], lists["own_lanes"],
                                  lists["own_slots"])
            paged_kv.append_lanes(pv, v_new[:, 0], lists["own_lanes"],
                                  lists["own_slots"])
            ctx = attention_api.paged_attention_sharded(
                q[:, 0].contiguous(), pk, pv, lists["block_list"],
                lists["block_req"], lists["block_pos"], seq_lens + 1,
                mesh=mesh, axis=axis)
            x = self._layer_tail_tp(lp, x, ctx, tp)
        x = rmsnorm(params["final_norm"], x[:, None], cfg.norm_eps)
        return self._unembed_tp(params, x, tp)[:, 0], pools

    def decode_tokens_paged(self, params, pools, lists, tokens, *,
                            num_lanes: Optional[int] = None,
                            attn_impl: str = "ragged", q_chunk: int = 16,
                            prefetch_depth: int = 0,
                            attn_tunables: Optional[Dict[str, int]] = None,
                            mesh=None, axis: str = "model"):
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
        identical either way at an equal split.  Each layer's op call is
        the ``model.attention`` span (:mod:`repro_torch.perf.spans`).

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

        ``mesh``: the mesh-native serving step (module docstring): params
        this rank's shard, ``pools["kv"]`` its (L, NB / S, ...) block,
        block_list/block_req/block_pos its LOCAL BlockList (its row of
        :meth:`BlockAllocator.build_sharded_block_lists`), and
        ``own_lanes`` (n,) / ``own_slots`` (n, 2) the lanes whose block it
        holds, at local slots (``num_lanes`` is then not read).  Each
        layer's attention goes through
        :func:`attention_api.paged_attention_ragged_sharded` or
        :func:`attention_api.paged_attention_chunked_sharded`.
        """
        if attn_impl not in ("ragged", "chunked"):
            raise ValueError(
                f"attn_impl {attn_impl!r}: expected 'ragged' or 'chunked'")
        if mesh is not None:
            return self._decode_tokens_sharded(
                params, pools, lists, tokens, attn_impl, q_chunk,
                prefetch_depth, attn_tunables, mesh, axis)
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
            with spans.span("model.attention"):
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

    def _decode_tokens_sharded(self, params, pools, lists, tokens,
                               attn_impl, q_chunk, prefetch_depth,
                               attn_tunables, mesh, axis):
        cfg = self.cfg
        a = cfg.attention
        tp = self.tensor_parallel(mesh, axis)
        pool = pools["kv"]
        token_pos = lists["token_pos"]
        tun = dict(attn_tunables or {})
        split_kw = {k: tun[k] for k in ("num_kv_pages_per_block",
                                        "vmem_limit_bytes") if k in tun}
        x = self._embed_tp(params, tokens, tp)              # (T, D)
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            lp = stacking.layer(lp_all, i)
            h = rmsnorm(lp["ln1"], x[:, None], cfg.norm_eps)
            q, k_new, v_new = attn_lib.project_qkv(lp["attn"], h, a,
                                                   token_pos[:, None], tp)
            paged_kv.append_lanes(
                pool[i], paged_kv.fuse_kv_heads(k_new[:, 0], v_new[:, 0]),
                lists["own_lanes"], lists["own_slots"])
            if attn_impl == "ragged":
                ctx = attention_api.paged_attention_ragged_sharded(
                    q[:, 0].contiguous(), pool[i], lists["block_list"],
                    lists["block_req"], lists["block_pos"],
                    lists["cu_q_lens"], lists["cu_kv_lens"],
                    lists["seq_slot"], mesh=mesh, axis=axis, **tun)
            else:
                pk, pv = paged_kv.fused_kv_views(pool[i])
                ctx = attention_api.paged_attention_chunked_sharded(
                    q[:, 0].contiguous(), pk, pv, lists["block_list"],
                    lists["block_req"], lists["block_pos"],
                    lists["kv_lens"], lists["token_req"], token_pos,
                    mesh=mesh, axis=axis, q_chunk=q_chunk,
                    prefetch_depth=prefetch_depth, **split_kw)
            x = self._layer_tail_tp(lp, x, ctx, tp)
        rows = lists.get("logit_lanes")
        if rows is None:
            x_sel = x[lists["last_lane"].long()][:, None]
        else:
            x_sel = x[rows.long()]                          # (B, R, D)
        x_sel = rmsnorm(params["final_norm"], x_sel, cfg.norm_eps)
        logits = self._unembed_tp(params, x_sel, tp)
        return (logits[:, 0] if rows is None else logits), pools



def decode_attention(params, h, k_cache, v_cache, seq_lens, a, *, tp=None,
                     path=("layers", "attn"), seq_split: bool = False):
    """One decode token against a contiguous cache layer: h (B, 1, D) the
    normed input, k_cache / v_cache (B, S, KV, hd) written IN PLACE at
    position ``seq_lens`` (B,), then attended over positions <= seq_lens
    (the new token included; the rest masked with NEG_INF, -1e30, as the
    reference).  Returns ctx (B, H * hd).

    ``tp`` (a ``TensorParallel``; ``path`` its params' place in the
    tree): the projections a rank holds split are gathered over the axis
    in one collective (``project_qkv``).  With ``seq_split`` the cache
    layer is this rank's block of the sequence, positions ``[r S, (r + 1)
    S)``: only the rank that holds position ``seq_lens[b]`` writes row b's
    K/V, each rank takes the partial output of its keys with its ``(m,
    l)`` (a row with no valid key here weighs nothing) and
    :func:`attention_api.combine_partials` joins them (one MAX, one SUM).
    Without it the rank attends over its whole cache, as one device."""
    B = h.shape[0]
    q, k_new, v_new = attn_lib.project_qkv(params, h, a, seq_lens[:, None],
                                           tp, path=path)
    rows = torch.arange(B, device=h.device)
    S = k_cache.shape[1]
    lo = tp.rank * S if seq_split else 0
    pos = seq_lens.long() - lo
    if seq_split:
        own = ((pos >= 0) & (pos < S))[:, None, None]
        pos = pos.clamp(0, S - 1)
        k_cache[rows, pos] = torch.where(own, k_new[:, 0], k_cache[rows, pos])
        v_cache[rows, pos] = torch.where(own, v_new[:, 0], v_cache[rows, pos])
    else:
        k_cache[rows, pos] = k_new[:, 0]
        v_cache[rows, pos] = v_new[:, 0]
    KV = a.num_kv_heads
    qg = q[:, 0].reshape(B, KV, a.num_heads // KV, a.head_dim)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float()
    scores = scores * a.head_dim ** -0.5
    mask = (lo + torch.arange(S, device=h.device)[None]
            <= seq_lens[:, None])[:, None, None]
    scores = torch.where(mask, scores, attn_lib.NEG_INF)
    if not seq_split:
        w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
        return torch.einsum("bkgs,bskd->bkgd", w, v_cache).reshape(B, -1)
    return attend_partial(scores, mask, v_cache, tp).reshape(B, -1).to(
        h.dtype)


def attend_partial(scores, valid, v, tp):
    """Softmax attention over a rank's block of the keys, joined over
    ``tp``'s axis: scores (B, KV, G, S) float32, masked with NEG_INF where
    ``valid`` is False; v (B, S, KV, hd).  Returns (B, H, hd) float32, the
    attention over every rank's keys."""
    from repro_torch.core.attention_api import combine_partials

    B, KV, G, _ = scores.shape
    m = scores.amax(dim=-1)                               # (B, KV, G)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float()
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return combine_partials(out.reshape(B, KV * G, -1), m, l, tp.mesh,
                            tp.axis)
