"""Plain PyTorch flash attention (GQA, causal optional; port of
``repro.kernels.flash_attention.ref``): the CPU path, and what the CUDA
kernel is held to.

As the JAX reference: the scores come from an einsum in the inputs' dtype,
then run in float32 (scaled, masked at -1e30 where ``row < col`` under the
causal mask, softmaxed), and the weights are cast to v's dtype before the
product with v.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bikgd,bjkd->bkgij", qg, k).float() * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgij,bjkd->bikgd", w, v)
    return o.reshape(B, Sq, H, hd)
