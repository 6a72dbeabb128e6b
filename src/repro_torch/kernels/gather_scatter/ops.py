"""GUPS-style random row gather and scatter (paper Fig 9; port of
``repro.kernels.gather_scatter.ops``).

The wrappers are objects chosen by the device of ``table``: for a CUDA
tensor they launch their kernel (``kernels/csrc/gather_scatter.cu``) or
raise, and add one to their ``launches``; for a CPU tensor they run their
plain version (:mod:`repro_torch.kernels.gather_scatter.ref`).

* :data:`vector_gather` ``(table, idx)`` -> ``table[idx]`` (N, D).
* :data:`vector_scatter_` ``(table, idx, src)`` writes the rows into
  ``table`` in place and returns it, as the TPU kernel updates its aliased
  table (``input_output_aliases={2: 0}``, ``kernel.py:63``).  Fig 9 times
  this one.
* :func:`vector_scatter` ``(table, idx, src)`` clones ``table`` and calls
  :data:`vector_scatter_`: a new table, as the JAX op returns.

Ids are int32; see :mod:`~repro_torch.kernels.gather_scatter.ref` for ids
outside ``[0, R)`` and repeated ids.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gather_scatter import ref
from repro_torch.kernels.launch import KernelOp, Launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(table, idx, rows=None):
    """Shapes on every device; on a card also dtypes, devices and
    contiguity.  ``rows`` is the (N, D) tensor beside the table, if any."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table {tuple(table.shape)} must be (R, D) and idx "
                         f"{tuple(idx.shape)} (N,)")
    if table.shape[0] < 1:
        raise ValueError("the table has no rows")
    if rows is not None and rows.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"src {tuple(rows.shape)} must be "
                         f"({idx.shape[0]}, {table.shape[1]})")
    if table.device.type != "cuda":
        return
    if table.dtype not in _DTYPES:
        raise TypeError(f"table dtype {table.dtype}: the kernels take "
                        "float32 or bfloat16")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    for name, t in (("idx", idx), ("src", rows)):
        if t is not None and t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, the table on "
                             f"{table.device}")
    if rows is not None and rows.dtype != table.dtype:
        raise TypeError(f"src dtype {rows.dtype} != table dtype "
                        f"{table.dtype}")
    for name, t in (("table", table), ("idx", idx), ("src", rows)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


class _Gather(KernelOp):
    name = "vector_gather"

    def plain(self, table, idx):
        _check(table, idx)
        return ref.gather_ref(table, idx)

    def prepare(self, table, idx) -> Launch:
        from repro_torch.kernels import gather_scatter as kernel

        _check(table, idx)
        R, D = table.shape
        out = torch.empty((idx.shape[0], D), dtype=table.dtype,
                          device=table.device)
        if idx.shape[0] == 0 or D == 0:
            return Launch(None, (), out, None)
        argv = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), R,
                idx.shape[0], D * table.element_size(), _DTYPES[table.dtype],
                _stream(table))
        return Launch(kernel.library().vector_gather, argv, out, None)


class _ScatterInPlace(KernelOp):
    name = "vector_scatter_"

    def plain(self, table, idx, src):
        _check(table, idx, src)
        return ref.scatter_ref_(table, idx, src)

    def prepare(self, table, idx, src) -> Launch:
        from repro_torch.kernels import gather_scatter as kernel

        _check(table, idx, src)
        R, D = table.shape
        if idx.shape[0] == 0 or D == 0:
            return Launch(None, (), table, None)
        winner = torch.empty((R,), dtype=torch.int32, device=table.device)
        argv = (table.data_ptr(), idx.data_ptr(), src.data_ptr(),
                winner.data_ptr(), R, idx.shape[0],
                D * table.element_size(), _DTYPES[table.dtype],
                _stream(table))
        return Launch(kernel.library().vector_scatter, argv, table, winner)


vector_gather = _Gather()
vector_scatter_ = _ScatterInPlace()
OPS = (vector_gather, vector_scatter_)


def vector_scatter(table: torch.Tensor, idx: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with ``src`` written at ``idx`` (through
    :data:`vector_scatter_`, which counts the launch)."""
    return vector_scatter_(table.clone(), idx, src)
