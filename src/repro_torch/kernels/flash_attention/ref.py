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
# The bf16 kernel's limit against this plain version on float32 q and k
# (see :func:`bf16_share`).
BF16_REL, BF16_FLOOR = 2 ** -7, 1e-4


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


def bf16_share(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, causal: bool = True) -> float:
    """Largest ``|got - want| / (2^-7 (M + |want|) + 1e-4)``: ``want`` the
    plain version on float32 q and k, ``M`` the same on ``|v|`` (the
    weights' mean of |v|).  At most 1 passes.

    With the scores in float32, as ``_flash_kernel`` takes them, a bf16
    kernel differs from ``want`` only where each rounds the weights (2^-8
    of M each) and the output (2^-8 |want| each) to bfloat16; 1e-4 covers
    the float32 sums' order.  The plain version on bf16 q and k rounds the
    scores to bf16 too, so it is held only to atol 2e-2."""
    want = flash_attention_ref(q.float(), k.float(), v, causal=causal).float()
    m = flash_attention_ref(q.float(), k.float(), v.abs(),
                            causal=causal).float()
    return ((got.float() - want).abs()
            / (BF16_REL * (m + want.abs()) + BF16_FLOOR)).max().item()
