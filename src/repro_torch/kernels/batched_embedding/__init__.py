"""Binding of the hand-written CUDA BatchedTable embedding-bag kernel, its
row-window form, its backward and the backward's row window
(``kernels/csrc/batched_embedding.cu``).  The wrappers that
check and launch them, and their plain PyTorch versions, live in
``repro_torch.core.embedding_api``."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "batched_embedding"


def library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, argtypes in ((lib.batched_embedding, [p, p, p, i64, i, i, i64, i,
                                                  p]),
                         (lib.batched_embedding_window, [p, p, p, i64, i,
                                                         i, i64, i64, i, p]),
                         (lib.batched_embedding_backward, [p, p, p, i64, i,
                                                           i, i64, p]),
                         (lib.batched_embedding_backward_window,
                          [p, p, p, i64, i, i, i64, i64, p])):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
