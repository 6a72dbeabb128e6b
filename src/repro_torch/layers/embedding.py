"""Token embedding / tied LM head (port of ``repro.layers.embedding``)."""
from __future__ import annotations

import torch


def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu"):
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=device) * d ** -0.5
    return {"table": table.to(dtype)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params_head, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) -> logits (..., V) in f32.

    The product runs in the operands' type (cuBLAS accumulates bf16 in
    f32) and the result is widened, so no f32 copy of the table is made.
    """
    return torch.matmul(x, params_head["table"].t()).float()
