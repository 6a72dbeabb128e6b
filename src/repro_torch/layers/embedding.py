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


def vocab_parallel_cross_entropy(params_head, x: torch.Tensor,
                                 targets: torch.Tensor, tp) -> torch.Tensor:
    """``softmax_cross_entropy(unembed(head, x), targets)`` over a
    row-sharded head without gathering the logits: each rank's logits of
    its vocabulary block (x entering the split through ``tp.enter``), the
    log-sum-exp from one MAX (no gradient: it only shifts) and one float32
    SUM over the axis, the target's logit from the rank that holds it and a
    SUM.  x (..., D), targets (...) int -> nll (...) float32; a target
    outside the vocabulary reads 0, as the reference's select does."""
    from repro_torch.distributed import collectives

    logits = unembed(params_head, tp.enter(x))            # (..., V / S)
    rows = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    collectives.all_reduce(m, tp.mesh, tp.axis, collectives.MAX)
    s = tp.psum(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = targets.long() - tp.rank * rows
    inside = (local >= 0) & (local < rows)
    tgt = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])[..., 0]
    tgt = tp.psum_exact(torch.where(inside, tgt, 0.0))
    return m + torch.log(s) - tgt
