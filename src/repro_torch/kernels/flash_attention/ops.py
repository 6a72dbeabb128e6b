"""Dense GQA flash attention (port of ``repro.kernels.flash_attention.ops``):
q (B, S, H, hd), k and v (B, S, KV, hd) -> (B, S, H, hd) in q's dtype.

:data:`flash_attention` is a wrapper object chosen by the device of ``q``:
for a CUDA tensor it launches the kernel (``kernels/csrc/flash_attention.cu``)
or raises, and adds one to its ``launches``; for a CPU tensor it runs the
plain :func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref`.
On every device it refuses what the TPU kernel's grid refuses: ``S`` not a
multiple of ``min(bq, S)`` or of ``min(bk, S)`` (``kernel.py:76``,
``ops.py:34``), and k or v of another sequence length than q (the grid
takes ``S`` from q alone, ``kernel.py:70-77``).  ``bq`` and ``bk`` are the
TPU kernel's tiles; the CUDA kernel tiles its own way, and its result does
not depend on them.

    out = flash_attention(q, k, v, causal=True, bq=512, bk=512)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.launch import KernelOp, Launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 64              # q heads per kv head: a tile's 64 rows


def check_shapes(q, k, v, bq: int, bk: int) -> None:
    """Raise on shapes the op does not take (on every device)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, S, H, hd) and k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} one "
                         "(B, S, KV, hd)")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if k.shape[1] != S:
        raise ValueError(f"k has {k.shape[1]} positions, q {S}: the op "
                         "takes one sequence length")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"{H} q heads over {k.shape[2]} kv heads")
    for name, tile in (("bq", bq), ("bk", bk)):
        if tile < 1 or (S and S % min(tile, S)):
            raise ValueError(f"S = {S} is not a multiple of min({name}, S) = "
                             f"{min(tile, S)}")


class _FlashAttentionOp(KernelOp):
    name = "flash_attention"

    def plain(self, q, k, v, causal: bool = True, bq: int = 512,
              bk: int = 512):
        check_shapes(q, k, v, bq, bk)
        return flash_attention_ref(q, k, v, causal=causal)

    def prepare(self, q, k, v, causal: bool = True, bq: int = 512,
                bk: int = 512) -> Launch:
        from repro_torch.kernels import flash_attention as kernel

        check_shapes(q, k, v, bq, bk)
        B, S, H, hd = q.shape
        KV = k.shape[2]
        if q.dtype not in _DTYPES or k.dtype != q.dtype or \
                v.dtype != q.dtype:
            raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, "
                            f"{v.dtype}: the kernel takes one of float32 "
                            "or bfloat16")
        if hd not in HEAD_DIMS:
            raise ValueError(f"head dim {hd}: the kernel takes {HEAD_DIMS}")
        if H // KV > MAX_GROUP:
            raise ValueError(f"{H // KV} q heads per kv head: the kernel "
                             f"takes at most {MAX_GROUP}")
        for name, t in (("k", k), ("v", v)):
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous and 16-byte "
                                 "aligned")
        out = torch.empty_like(q)
        if B == 0 or S == 0 or H == 0:
            return Launch(None, (), out, None)
        argv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                S, H, KV, hd, int(causal), hd ** -0.5, _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
        return Launch(kernel.library().flash_attention, argv, out, None)


flash_attention = _FlashAttentionOp()
