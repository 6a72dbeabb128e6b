"""GQA attention (port of ``repro.layers.attention``): projections, two
plain attention cores for the models' ``forward``, and the whisper
decoder's cross-attention over encoder K/V computed once.

* :func:`full_attention`: O(S^2) reference.
* :func:`chunked_attention`: a loop over query chunks, full KV per chunk
  (bounded memory); the form ``forward`` runs.
* serving's decode and prefill go through ``repro_torch.core.
  attention_api`` over the paged KV pool.

The reference runs these cores outside any Pallas kernel; their products
go to ``torch.matmul``/``einsum`` here, as JAX leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.config import AttentionConfig
from repro_torch.layers.mlp import dense_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init
from repro_torch.layers.rope import apply_rope

NEG_INF = -1e30


def attention_init(gen: torch.Generator, d_model: int, a: AttentionConfig,
                   dtype=torch.float32, device="cpu"):
    q_dim, kv_dim = a.num_heads * a.head_dim, a.num_kv_heads * a.head_dim
    p = {
        "wq": dense_init(gen, d_model, q_dim, dtype, device),
        "wk": dense_init(gen, d_model, kv_dim, dtype, device),
        "wv": dense_init(gen, d_model, kv_dim, dtype, device),
        "wo": dense_init(gen, q_dim, d_model, dtype, device),
    }
    if a.qkv_bias:
        for name, n in (("bq", a.num_heads), ("bk", a.num_kv_heads),
                        ("bv", a.num_kv_heads)):
            p[name] = torch.zeros((n * a.head_dim,), dtype=dtype,
                                  device=device)
    if a.qk_norm:
        p["q_norm"] = rmsnorm_init(a.head_dim, dtype, device)
        p["k_norm"] = rmsnorm_init(a.head_dim, dtype, device)
    return p


def project_qkv(params, x: torch.Tensor, a: AttentionConfig,
                positions: torch.Tensor, tp=None, path=("layers", "attn")):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope applied.

    ``tp`` (a ``TensorParallel``): each of ``wq``/``wk``/``wv`` that the
    rules split holds this rank's whole heads, and the products of those
    are gathered over the axis in one collective (every rank needs every
    head: the KV pool is sharded by sequence, not by head); one left whole
    is applied as it is.  ``path``: the params' place in the tree, where
    ``tp`` reads their specs."""
    B, S, _ = x.shape
    qkv = {name: torch.matmul(x, params[name]) for name in ("wq", "wk", "wv")}
    if tp is not None:
        split = [n for n in qkv if tp.split(*path, n)]
        if split:
            qkv.update(zip(split, tp.gather_last([qkv[n] for n in split])))
    q, k, v = qkv["wq"], qkv["wk"], qkv["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, a.num_heads, a.head_dim)
    k = k.reshape(B, S, a.num_kv_heads, a.head_dim)
    v = v.reshape(B, S, a.num_kv_heads, a.head_dim)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    return q, k, v


def _group(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd) grouped by kv head."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, num_kv, H // num_kv, hd)


def _attend(qg, k, v, mask):
    """Softmax attention of grouped queries (B,Sq,KV,G,hd) over k/v
    (B,Sk,KV,hd), f32 scores, ``mask`` (Sq, Sk) or None; weights cast to
    v's dtype for the PV product.  Returns (B,Sq,KV,G,hd)."""
    hd = qg.shape[-1]
    scores = torch.einsum("bikgd,bjkd->bkgij", qg, k).float() * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgij,bjkd->bikgd", w, v)


def full_attention(q, k, v, *, causal: bool = True, q_positions=None,
                   kv_positions=None) -> torch.Tensor:
    """Reference attention. q (B,Sq,H,hd); k,v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    mask = None
    if causal:
        qi = (q_positions if q_positions is not None
              else torch.arange(Sq, device=q.device))
        kj = (kv_positions if kv_positions is not None
              else torch.arange(k.shape[1], device=q.device))
        mask = qi[:, None] >= kj[None, :]
    return _attend(_group(q, k.shape[2]), k, v, mask).reshape(B, Sq, H, hd)


def chunked_attention(q, k, v, *, causal: bool = True,
                      chunk: int = 512) -> torch.Tensor:
    """Query-chunked attention: one pass per chunk of ``chunk`` queries
    against the full KV, so scores are (B, KV, G, chunk, Sk) at most.

    As in the reference: ``Sq <= chunk`` is one full pass; otherwise the
    chunk is the largest divisor of ``Sq`` not above ``chunk``, and a
    divisor below 32 falls back to :func:`full_attention`.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if Sq <= chunk:
        return full_attention(q, k, v, causal=causal)
    if Sq % chunk != 0:
        c = chunk
        while Sq % c != 0:
            c -= 1
        if c < 32:
            return full_attention(q, k, v, causal=causal)
        chunk = c
    qg = _group(q, KV)
    kj = torch.arange(Sk, device=q.device)
    outs = []
    for i in range(Sq // chunk):
        mask = None
        if causal:
            qi = i * chunk + torch.arange(chunk, device=q.device)
            mask = qi[:, None] >= kj[None, :]
        outs.append(_attend(qg[:, i * chunk:(i + 1) * chunk], k, v, mask))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def attention_block(params, x, positions, a: AttentionConfig, *,
                    causal=None, chunk: int = 512):
    """Attention block for prefill and loss. Returns (out, (k, v))."""
    causal = a.causal if causal is None else causal
    q, k, v = project_qkv(params, x, a, positions)
    ctx = chunked_attention(q, k, v, causal=causal, chunk=chunk)
    B, S = x.shape[:2]
    out = torch.matmul(ctx.reshape(B, S, -1), params["wo"])
    return out, (k, v)


def cross_attention_block(params, x, kv_cache, a: AttentionConfig):
    """Whisper decoder cross-attention: K/V precomputed from the encoder
    (:func:`encode_kv`), no RoPE.  x (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    q = torch.matmul(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(B, S, a.num_heads, a.head_dim)
    k, v = kv_cache
    ctx = full_attention(q, k, v, causal=False)
    return torch.matmul(ctx.reshape(B, S, -1), params["wo"])


def encode_kv(params, enc, a: AttentionConfig):
    """Project the encoder output to cross-attention K/V once (cached)."""
    B, S, _ = enc.shape
    k = torch.matmul(enc, params["wk"])
    v = torch.matmul(enc, params["wv"])
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    return (k.reshape(B, S, a.num_kv_heads, a.head_dim),
            v.reshape(B, S, a.num_kv_heads, a.head_dim))


def attention_block_tp(params, x, positions, a: AttentionConfig, tp, *,
                       causal=None, chunk: int = 512,
                       path=("layers", "attn")) -> torch.Tensor:
    """:func:`attention_block` (its output only) with Megatron's split over
    ``tp``'s axis, for training on a mesh: x (B, S, D) whole on every
    rank; ``wq`` (and ``wk``/``wv`` where the rules split them: whole kv
    heads a rank) column-parallel, so each rank attends with its block of
    whole query heads, and ``wo`` row-parallel over the same heads, its
    partial products summed in float32.  A whole ``wk``/``wv`` gives every
    kv head on every rank, and each rank keeps those its query heads read.
    Whole tensors that feed the split part (x, a whole k/v, the biases and
    q/k norms) go through ``tp.enter``, so their gradients come back
    whole.  With ``wq`` whole the block runs whole on every rank.
    ``path``: the params' place in the tree, where ``tp`` reads their
    specs."""
    if not tp.split(*path, "wq"):
        return attention_block(params, x, positions, a, causal=causal,
                               chunk=chunk)[0]
    causal = a.causal if causal is None else causal
    q, k, v = _heads_tp(params, x, x, a, tp, path, positions)
    ctx = chunked_attention(q, k, v, causal=causal, chunk=chunk)
    return _out_tp(params, ctx, tp)


def _out_tp(params, ctx, tp):
    """``ctx`` (B, S, H', hd) of this rank's query heads times ``wo``,
    row-parallel (the rules split ``wo`` where they split ``wq``: its rows
    are the same heads), summed in float32."""
    B, S = ctx.shape[:2]
    return tp.psum(torch.matmul(ctx.reshape(B, S, -1), params["wo"]))


def _heads_tp(params, xq, xkv, a: AttentionConfig, tp, path,
              positions=None):
    """q (B, Sq, H', hd) of this rank's block of whole query heads (``wq``
    split), and k, v (B, Sk, H' / G or H', hd) of the kv heads those read,
    from xq and xkv (whole on every rank); RoPE at ``positions`` (None:
    none, cross-attention).  A whole ``wk``/``wv`` gives every kv head, of
    which the rank keeps its own.  Whole tensors that feed the split part
    go through ``tp.enter``."""
    B, Sq, _ = xq.shape
    Sk = xkv.shape[1]
    hd, H, KV = a.head_dim, a.num_heads, a.num_kv_heads
    split_kv = tp.split(*path, "wk")
    xin = tp.enter(xq)
    if not split_kv:            # whole k/v: entered after, as they are cut
        xk = xkv
    else:
        xk = xin if xkv is xq else tp.enter(xkv)
    q = torch.matmul(xin, params["wq"])
    k = torch.matmul(xk, params["wk"])
    v = torch.matmul(xk, params["wv"])
    qlo, qhi = tp.bounds(H)
    if "bq" in params:
        q = q + tp.enter(params["bq"])[qlo * hd:qhi * hd]
        kb, vb = params["bk"], params["bv"]
        if split_kv:
            klo, khi = tp.bounds(KV)
            kb = tp.enter(kb)[klo * hd:khi * hd]
            vb = tp.enter(vb)[klo * hd:khi * hd]
        k, v = k + kb, v + vb
    q = q.reshape(B, Sq, qhi - qlo, hd)
    k = k.reshape(B, Sk, -1, hd)
    v = v.reshape(B, Sk, -1, hd)
    if "q_norm" in params:
        q = rmsnorm(tp.enter(params["q_norm"]), q)
        k = rmsnorm(tp.enter(params["k_norm"]) if split_kv
                    else params["k_norm"], k)
    if positions is not None:
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
    if not split_kv:             # every kv head here: keep this rank's
        G = H // KV
        k, v = tp.enter(k), tp.enter(v)
        if (qhi - qlo) % G == 0:
            k, v = k[:, :, qlo // G:qhi // G], v[:, :, qlo // G:qhi // G]
        else:                    # a query block inside one group: a kv
            idx = torch.arange(qlo, qhi, device=xq.device) // G  # head each
            k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v


def cross_attention_block_tp(params, x, enc, a: AttentionConfig, tp,
                             path) -> torch.Tensor:
    """:func:`cross_attention_block` over the encoder output ``enc``
    (B, Se, D), whole on every rank, with Megatron's split where the rules
    split ``wq``: each rank its query heads and their kv heads, ``wo``
    row-parallel; whole on every rank otherwise.  For training."""
    if not tp.split(*path, "wq"):
        return cross_attention_block(params, x, encode_kv(params, enc, a), a)
    q, k, v = _heads_tp(params, x, enc, a, tp, path)
    return _out_tp(params, full_attention(q, k, v, causal=False), tp)


def out_proj_tp(ctx: torch.Tensor, wo: torch.Tensor, tp) -> torch.Tensor:
    """``ctx @ wo`` with ``wo`` row-parallel (this rank's whole heads of
    its input rows): the rank's heads of the whole ``ctx`` times its rows,
    summed over the axis in float32."""
    lo, hi = tp.bounds(ctx.shape[-1])
    return tp.psum(torch.matmul(ctx[..., lo:hi], wo))
