"""Embedding-bag lookups: the SingleTable baseline, the fused BatchedTable
plain version, and the wrapper of the hand-written CUDA kernel (port of
``repro.core.embedding_api``, the paper's §4.1 FBGEMM/DLRM case study).

* :func:`single_table_lookup`: one gather and one sum **per table** (the
  SingleTable baseline), T separate launches on purpose.
* :func:`batched_table_lookup`: the paper's BatchedTable.  All tables are
  concatenated into one tall table, per-table start offsets turn local row
  ids into global rows, and one gather + pool serves every (table, bag)
  pair.  It is the plain version: the CPU path, and what the kernel is held
  to.
* :data:`embedding_bag`: the wrapper the model calls.  For a CUDA table it
  launches the kernel (``kernels/csrc/batched_embedding.cu``) or raises;
  for a CPU table it takes :func:`batched_table_lookup`.  Nothing falls
  back.

Bags are fixed-size (pooling factor L, as in the paper's RM configs):
indices (B, T, L) local row ids -> pooled (B, T, D).  A global id ``g`` of
a table with R rows reads row ``g + R`` for ``g`` in ``[-R, 0)`` and gives
a NaN bag for ``g`` outside ``[-R, R)``, as ``jnp.take``'s fill mode does.
Sums run in float32 and come back in the table's dtype, as the TPU kernel
(``batched_embedding_pallas``) sums.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_BYTES = 2048       # 32 lanes x 4 vectors of 16 bytes


def concat_tables(tables: Sequence[torch.Tensor]):
    """Stack per-table (rows_t, dim) tensors -> (sum rows, dim) + offsets
    (T,) int32."""
    offs = np.cumsum([0] + [t.shape[0] for t in tables[:-1]]).astype(np.int32)
    return (torch.cat(list(tables), dim=0),
            torch.from_numpy(offs).to(tables[0].device))


def single_table_lookup(tables: Sequence[torch.Tensor],
                        indices: torch.Tensor) -> torch.Tensor:
    """Baseline: per-table gathers (T separate gathers and sums).

    indices (B, T, L) local row ids in ``[0, rows_t)``.  Returns pooled
    (B, T, D) in the tables' dtype.
    """
    outs: List[torch.Tensor] = []
    B, T, L = indices.shape
    for t in range(T):      # one gather per table: the baseline's cost
        rows = tables[t].index_select(0, indices[:, t].reshape(-1))
        outs.append(rows.view(B, L, -1).sum(dim=1))
    return torch.stack(outs, dim=1)


def batched_table_lookup(big_table: torch.Tensor, table_offsets: torch.Tensor,
                         indices: torch.Tensor) -> torch.Tensor:
    """Fused: ONE gather over the concatenated table (the plain version).

    big_table (R, D); table_offsets (T,); indices (B, T, L) local row ids.
    Returns pooled (B, T, D) in the table's dtype, summed in float32 in
    the order of ``l``, as the TPU kernel and the CUDA kernel sum.
    """
    B, T, L = indices.shape
    R, D = big_table.shape
    gid = (indices + table_offsets[None, :, None]).reshape(-1).long()
    bad = (gid < -R) | (gid >= R)
    gid = torch.where(gid < 0, gid + R, gid).masked_fill(bad, 0)
    rows = big_table.index_select(0, gid).float()
    rows = rows.masked_fill(bad[:, None], float("nan")).view(B, T, L, D)
    acc = torch.zeros((B, T, D), dtype=torch.float32, device=rows.device)
    for l in range(L):      # in order of l, as the kernels sum
        acc += rows[:, :, l]
    return acc.to(big_table.dtype)


def _check_cuda_inputs(big_table, table_offsets, indices):
    dev = big_table.device
    if big_table.dtype not in _DTYPES:
        raise TypeError(f"table dtype {big_table.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if big_table.dim() != 2 or indices.dim() != 3 or table_offsets.dim() != 1:
        raise ValueError(f"table {tuple(big_table.shape)} must be (R, D), "
                         f"indices {tuple(indices.shape)} (B, T, L) and "
                         f"table_offsets {tuple(table_offsets.shape)} (T,)")
    if table_offsets.shape[0] != indices.shape[1]:
        raise ValueError(f"{table_offsets.shape[0]} table offsets for "
                         f"{indices.shape[1]} tables")
    for name, t in (("indices", indices), ("table_offsets", table_offsets)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the table on {dev}")
    if not big_table.is_contiguous():
        raise ValueError("the table must be contiguous")
    row_bytes = big_table.shape[1] * big_table.element_size()
    if row_bytes % 16 or row_bytes > _MAX_ROW_BYTES:
        raise ValueError(f"rows of {row_bytes} bytes: the kernel takes rows "
                         f"of a multiple of 16 bytes, at most "
                         f"{_MAX_ROW_BYTES}")
    if big_table.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (the kernel "
                         "loads 16 bytes at a time)")


class _EmbeddingBagOp:
    """BatchedTable embedding bag, chosen by the device of the table.

    CUDA: checks dtypes, shapes, devices, contiguity and alignment, forms
    the global ids ``indices + table_offsets[None, :, None]``, allocates
    the output with ``torch.empty``, launches on the current stream and
    adds one to :attr:`launches`.  The kernel checks the ids itself (no
    sync): ids in ``[-R, 0)`` wrap, a bag with an id outside ``[-R, R)``
    is NaN.  CPU: the plain :func:`batched_table_lookup`.
    """

    def __init__(self):
        self.launches = 0           # kernel launches, a plain integer

    def __call__(self, big_table, table_offsets, indices):
        if big_table.device.type != "cuda":
            return batched_table_lookup(big_table, table_offsets, indices)
        from repro_torch.kernels import batched_embedding as kernel

        _check_cuda_inputs(big_table, table_offsets, indices)
        B, T, L = indices.shape
        R, D = big_table.shape
        out = torch.empty((B, T, D), dtype=big_table.dtype,
                          device=big_table.device)
        if B * T == 0:
            return out
        global_ids = (indices + table_offsets[None, :, None]).reshape(-1)
        err = kernel.library().batched_embedding(
            big_table.data_ptr(), global_ids.data_ptr(), out.data_ptr(),
            B * T, L, D, R, _DTYPES[big_table.dtype],
            torch.cuda.current_stream(big_table.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"batched_embedding kernel launch failed: "
                               f"cudaError {err}")
        self.launches += 1
        return out


embedding_bag = _EmbeddingBagOp()
