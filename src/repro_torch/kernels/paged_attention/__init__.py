"""Binding of the hand-written CUDA ragged paged-attention kernel
(``kernels/csrc/paged_attention_ragged.cu``).  The wrapper that checks and
launches it, and its plain PyTorch version, live in
``repro_torch.core.attention_api``."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "paged_attention_ragged"


def library() -> ctypes.CDLL:
    """The kernel library with its C signature declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    fn = lib.paged_attention_ragged
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 10 + [i] * 9 + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return lib
