"""Binding of the hand-written CUDA BatchedTable embedding-bag kernel
(``kernels/csrc/batched_embedding.cu``).  The wrapper that checks and
launches it, and its plain PyTorch version, live in
``repro_torch.core.embedding_api``."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "batched_embedding"


def library() -> ctypes.CDLL:
    """The kernel library with its C signature declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    fn = lib.batched_embedding
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i64, i, i, i64, i, p]
        fn.restype = ctypes.c_int
    return lib
