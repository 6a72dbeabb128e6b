"""Binding of the hand-written CUDA gather and scatter kernels
(``kernels/csrc/gather_scatter.cu``).  The wrappers that check and launch
them are in :mod:`repro_torch.kernels.gather_scatter.ops`, their plain
PyTorch versions in :mod:`repro_torch.kernels.gather_scatter.ref`."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "gather_scatter"


def library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn, argtypes in ((lib.vector_gather, [p, p, p, i64, i64, i, i, p]),
                         (lib.vector_scatter,
                          [p, p, p, p, i64, i64, i, i, p])):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
