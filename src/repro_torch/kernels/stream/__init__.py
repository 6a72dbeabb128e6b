"""Binding of the hand-written CUDA STREAM kernels
(``kernels/csrc/stream.cu``).  The wrappers that check and launch them are
in :mod:`repro_torch.kernels.stream.ops`, their plain PyTorch versions in
:mod:`repro_torch.kernels.stream.ref`."""
from __future__ import annotations

import ctypes
from typing import Dict

from repro_torch.kernels import build

SOURCE = "stream"
# what stream_plan writes, in its order
PLAN_KEYS = ("grid", "units", "unit_bytes", "sms", "blocks_per_sm", "threads",
             "queued")


def library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first
    use; this needs ``nvcc`` and a card)."""
    lib = build.load(SOURCE)
    fn = lib.stream
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, ctypes.c_longlong, ctypes.c_float, i, i,
                       p]
        fn.restype = ctypes.c_int
        lib.stream_plan.argtypes = [i, ctypes.c_longlong, i, i, p, p]
        lib.stream_plan.restype = ctypes.c_int
    return lib


def plan(op: int, n: int, block_rows: int, dtype: int) -> Dict[str, int]:
    """What the kernel launches for ``op`` on ``n`` elements of ``dtype``
    (0 float32, 1 bfloat16) at ``block_rows`` on the current card and
    stream: its grid, its units and the bytes of a unit of one array (whole
    tiles, or a piece of one), the card's SMs and resident blocks per SM,
    threads per block, and the units past the first two rounds that the
    blocks take from the work queue."""
    import torch

    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = library().stream_plan(op, n, block_rows, dtype,
                                torch.cuda.current_stream().cuda_stream, out)
    if err != 0:
        raise RuntimeError(f"stream_plan failed: cudaError {err}")
    return dict(zip(PLAN_KEYS, out))
