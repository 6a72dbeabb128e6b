"""Bindings of the hand-written CUDA paged-attention kernels
(``kernels/csrc/paged_attention_{ragged,chunked,decode}.cu``, which share
``paged_attention_common.cuh`` and the decode tile
``paged_decode_tile.cuh``).  The wrappers that check and launch them,
and their plain PyTorch versions, live in ``repro_torch.core.attention_api``.
"""
from __future__ import annotations

import ctypes

from repro_torch.kernels import build

SOURCE = "paged_attention_ragged"
CHUNKED_SOURCE = "paged_attention_chunked"
DECODE_SOURCE = "paged_attention_decode"

_p, _i, _i64, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# C signature of each source's entry point (named like the source).
_ARGTYPES = {
    SOURCE: [_p] * 12 + [_i] * 13 + [_f, _p],
    CHUNKED_SOURCE: [_p] * 13 + [_i] * 12 + [_i64] * 3 + [_i, _f, _p],
    DECODE_SOURCE: [_p] * 11 + [_i] * 10 + [_i64] * 3 + [_i, _f, _p],
}


def library(source: str = SOURCE) -> ctypes.CDLL:
    """The kernel library of ``source`` with its C signatures declared
    (built on first use; this needs ``nvcc`` and a card).  Each library
    also exports ``<source>_smem_bytes``, the dynamic shared memory of its
    attention instances: ``(hd, dtype)`` for ragged and chunked, ``(hd,
    dtype, G)`` for decode, whose blocks size it by G (:func:`smem_bytes`)."""
    lib = build.load(source)
    fn = getattr(lib, source)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[source]
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"{source}_smem_bytes")
        smem.argtypes = [_i] * (3 if source == DECODE_SOURCE else 2)
        smem.restype = ctypes.c_int
    return lib


def smem_bytes(source: str, hd: int, dtype: int, group: int) -> int:
    """The dynamic shared memory a launch of ``source``'s kernel requests at
    head dim ``hd``, dtype code ``dtype`` and ``group`` query heads per kv
    head."""
    fn = getattr(library(source), f"{source}_smem_bytes")
    return fn(hd, dtype, group) if source == DECODE_SOURCE else fn(hd, dtype)
