"""Binding of the hand-written CUDA STREAM kernels
(``kernels/csrc/stream.cu``).  The wrappers that check and launch them are
in :mod:`repro_torch.kernels.stream.ops`, their plain PyTorch versions in
:mod:`repro_torch.kernels.stream.ref`."""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "stream"


def library() -> ctypes.CDLL:
    """The kernel library with its C signature declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    fn = lib.stream
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, ctypes.c_longlong, ctypes.c_float, i, i,
                       p]
        fn.restype = ctypes.c_int
    return lib
