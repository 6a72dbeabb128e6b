"""GQA attention (port of ``repro.layers.attention``): projections, and
two plain attention cores for ``TransformerLM.forward``.

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
                positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd), rope applied."""
    B, S, _ = x.shape
    q = torch.matmul(x, params["wq"])
    k = torch.matmul(x, params["wk"])
    v = torch.matmul(x, params["wv"])
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
