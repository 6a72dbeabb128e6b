"""Binding of the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``).  The wrapper that checks and
launches it is :data:`repro_torch.kernels.flash_attention.ops.flash_attention`,
its plain PyTorch version
:func:`repro_torch.kernels.flash_attention.ref.flash_attention_ref`."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "flash_attention"


def library() -> ctypes.CDLL:
    """The kernel library with its C signature declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    fn = lib.flash_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 6 + [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib
