"""GQA attention projections (port of ``repro.layers.attention``).

Decode and prefill attention themselves go through
``repro_torch.core.attention_api`` over the paged KV pool.
"""
from __future__ import annotations

import torch

from repro_torch.config import AttentionConfig
from repro_torch.layers.mlp import dense_init
from repro_torch.layers.norm import rmsnorm, rmsnorm_init
from repro_torch.layers.rope import apply_rope


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
