"""Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates,
without sparsity, at the full 700 W limit)."""
from __future__ import annotations

BF16_FLOPS = 989e12          # FLOP/s, bf16 and fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12    # bytes/s
HBM_BYTES = 80e9


def roofline_s(flops: float, nbytes: float):
    """(least seconds, "flops" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (t_ops, "flops") if t_ops >= t_bytes else (t_bytes, "bytes")
