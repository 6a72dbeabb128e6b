"""Rotary position embeddings, LLaMA-style half rotation (port of
``repro.layers.rope``)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate x (..., S, H, hd) by positions (..., S). f32 math, keeps dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs      # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]              # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
