"""Token embedding / tied LM head (port of ``repro.layers.embedding``),
and their vocabulary-parallel forms over a mesh axis (Megatron's): each
rank holds a contiguous block of the table's rows."""
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


def embed_vocab_parallel(params, tokens: torch.Tensor, tp) -> torch.Tensor:
    """:func:`embed` over a row-sharded table: each rank looks up the ids
    its rows hold, the others give zeros, and a SUM over the axis (exact:
    one rank holds each row) gives the whole embedding on every rank.
    ``tp``: a :class:`repro_torch.distributed.sharding.TensorParallel`."""
    table = params["table"]
    rows = table.shape[0]
    local = tokens.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].masked_fill(~inside[..., None], 0)
    return tp.psum_exact(x)


def unembed_vocab_parallel(params_head, x: torch.Tensor, tp) -> torch.Tensor:
    """:func:`unembed` over a row-sharded table: each rank's logits of its
    vocabulary block, gathered along the vocabulary in rank order."""
    return tp.gather(unembed(params_head, x), dim=-1)
