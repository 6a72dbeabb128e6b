"""Plain PyTorch versions of the STREAM microbenchmarks (paper Alg 1; port
of ``repro.kernels.stream.ref``): the CPU path, and what the CUDA kernels
are held to, bitwise.

The scalar is rounded to the array's dtype first, as the TPU kernels cast
it (``kernel.py:62``, ``:69``) and as JAX's weak typing rounds a Python
scalar.  TRIAD rounds its product before its add.
"""
from __future__ import annotations

import torch


def cast_scalar(scalar: float, dtype: torch.dtype) -> float:
    """``scalar`` rounded to ``dtype`` (returned as a Python float, which
    holds it exactly)."""
    return torch.tensor(scalar, dtype=dtype).item()


def add_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def scale_ref(a: torch.Tensor, scalar: float) -> torch.Tensor:
    return cast_scalar(scalar, a.dtype) * a


def triad_ref(a: torch.Tensor, b: torch.Tensor,
              scalar: float) -> torch.Tensor:
    return cast_scalar(scalar, a.dtype) * a + b
