"""STREAM ADD, SCALE and TRIAD (paper Alg 1, Fig 8; port of
``repro.kernels.stream.ops``): 1-D arrays of whole 128-element rows, cut
into tiles of ``block_rows`` rows.

Each op is a wrapper object chosen by the device of ``a``: for a CUDA
tensor it launches its kernel (``kernels/csrc/stream.cu``) or raises, and
adds one to its ``launches``; for a CPU tensor it runs its plain version
(:mod:`repro_torch.kernels.stream.ref`).  Both refuse an ``n`` that is not
a multiple of 128, and a row count that ``block_rows`` does not divide:
the TPU kernel's grid ``rows // block_rows`` (``kernel.py:36``) would leave
the tail rows unwritten there.

    out = stream_add(a, b, block_rows=256)
    out = stream_scale(a, scalar, block_rows=256)
    out = stream_triad(a, b, scalar, block_rows=256)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.launch import KernelOp, Launch
from repro_torch.kernels.stream import ref

LANES = 128
ADD, SCALE, TRIAD = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shape(a: torch.Tensor, block_rows: int,
                b: Optional[torch.Tensor] = None) -> None:
    """Raise unless ``a`` (and ``b``) is 1-D of whole 128-element rows and
    ``block_rows`` divides the rows."""
    if a.dim() != 1:
        raise ValueError(f"a {tuple(a.shape)} must be 1-D")
    if b is not None and b.shape != a.shape:
        raise ValueError(f"b {tuple(b.shape)} and a {tuple(a.shape)} differ")
    n = a.shape[0]
    if n % LANES:
        raise ValueError(f"n = {n} is not a multiple of {LANES}")
    if block_rows < 1 or (n // LANES) % block_rows:
        raise ValueError(f"block_rows = {block_rows} does not divide the "
                         f"{n // LANES} rows")


def _prepare(op: int, a, b, scalar: float, block_rows: int) -> Launch:
    from repro_torch.kernels import stream as kernel

    check_shape(a, block_rows, b)
    for name, t in (("a", a), ("b", b)):
        if t is None:
            continue
        if t.dtype not in _DTYPES or t.dtype != a.dtype:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32 or bfloat16 arrays of one dtype")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned (the kernel moves 16 bytes at a time)")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return Launch(None, (), out, None)
    argv = (op, a.data_ptr(), 0 if b is None else b.data_ptr(),
            out.data_ptr(), a.numel(), ref.cast_scalar(scalar, a.dtype),
            block_rows, _DTYPES[a.dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    return Launch(kernel.library().stream, argv, out, None)


class _Add(KernelOp):
    name = "stream_add"

    def plain(self, a, b, block_rows: int = 256):
        check_shape(a, block_rows, b)
        return ref.add_ref(a, b)

    def prepare(self, a, b, block_rows: int = 256) -> Launch:
        return _prepare(ADD, a, b, 0.0, block_rows)


class _Scale(KernelOp):
    name = "stream_scale"

    def plain(self, a, scalar, block_rows: int = 256):
        check_shape(a, block_rows)
        return ref.scale_ref(a, scalar)

    def prepare(self, a, scalar, block_rows: int = 256) -> Launch:
        return _prepare(SCALE, a, None, scalar, block_rows)


class _Triad(KernelOp):
    name = "stream_triad"

    def plain(self, a, b, scalar, block_rows: int = 256):
        check_shape(a, block_rows, b)
        return ref.triad_ref(a, b, scalar)

    def prepare(self, a, b, scalar, block_rows: int = 256) -> Launch:
        return _prepare(TRIAD, a, b, scalar, block_rows)


stream_add = _Add()
stream_scale = _Scale()
stream_triad = _Triad()
OPS = (stream_add, stream_scale, stream_triad)
