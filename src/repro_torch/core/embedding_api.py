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
* :func:`batched_table_lookup_sharded`: row-sharded tables over a mesh
  axis; each rank pools its rows through :data:`embedding_bag_window`
  (the kernel's row-window form on a card, :func:`batched_table_window_
  lookup` on the CPU) and a SUM combines, whose backward is the identity.
  Where the table requires grad the window is an autograd Function whose
  backward is :data:`embedding_bag_backward_window` (the backward kernel's
  row window on a card, :func:`batched_table_backward_window` on the
  CPU): each rank writes the gradient of its own rows.
* :data:`embedding_bag`: the wrapper the model calls.  For a CUDA table it
  launches the kernel (``kernels/csrc/batched_embedding.cu``) or raises;
  for a CPU table it takes :func:`batched_table_lookup`.  Nothing falls
  back.  Where the table requires grad (and grad is on), the call is a
  ``torch.autograd.Function`` whose backward is
  :data:`embedding_bag_backward`: the hand-written backward kernel on the
  card, the plain :func:`batched_table_backward` on the CPU.  No gradient
  flows to the offsets or the ids, and a table that requires grad must be
  float32.

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

from repro_torch.kernels.launch import KernelOp, Launch

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


def batched_table_window_lookup(table: torch.Tensor,
                                table_offsets: torch.Tensor,
                                indices: torch.Tensor, lo: int,
                                hi: int) -> torch.Tensor:
    """The plain version of the row-window lookup: ``table`` (hi - lo, D)
    holds global rows ``[lo, hi)`` of the concatenated table; each bag sums
    the rows of its global ids (``indices + table_offsets``) that lie in
    the window, the others adding nothing (no wrap, no NaN: the
    reference's sharded lookup).  Sums in float32 in the order of ``l``,
    returned in the table's dtype."""
    B, T, L = indices.shape
    gid = (indices + table_offsets[None, :, None]).reshape(-1).long()
    local = gid - lo
    inside = (local >= 0) & (local < hi - lo)
    rows = table.index_select(0, local.clamp(0, hi - lo - 1)).float()
    rows = rows.masked_fill(~inside[:, None], 0.0).view(B, T, L, -1)
    acc = torch.zeros((B, T, table.shape[1]), dtype=torch.float32,
                      device=rows.device)
    for l in range(L):      # in order of l, as the kernel sums
        acc += rows[:, :, l]
    return acc.to(table.dtype)


def batched_table_lookup_sharded(big_table: torch.Tensor,
                                 table_offsets: torch.Tensor,
                                 indices: torch.Tensor, *, mesh,
                                 axis: str = "model") -> torch.Tensor:
    """Row-sharded tables (port of the reference's
    ``batched_table_lookup_sharded``, TorchRec's row-wise parallel
    embedding): ``big_table`` is this rank's contiguous block of the
    concatenated table's rows (rank r of A holds ``[r R/A, (r+1) R/A)``),
    each rank pools the rows it owns through :data:`embedding_bag_window`
    (the row-window kernel on a card) and a SUM over ``axis`` combines.
    Returns the pooled (B, T, D) on every rank."""
    from repro_torch.distributed import collectives

    rows = big_table.shape[0]
    lo = mesh.axis_index(axis) * rows
    pooled = embedding_bag_window(big_table, table_offsets, indices, lo,
                                  lo + rows)
    return collectives.reduce_from(pooled, mesh, axis)


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


def batched_table_backward(grad_out: torch.Tensor, global_ids: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """The gradient of :func:`batched_table_lookup` with respect to the
    table (the plain version of the backward kernel).

    grad_out (B, T, D) float32; global_ids (B*T*L,) the forward's global
    ids.  Returns the dense (num_rows, D) float32 gradient: grad_out[b]
    added into the row of every id of bag b, an id in ``[-R, 0)`` into row
    id + R, an id outside ``[-R, R)`` nowhere (as ``jax.grad`` of the
    reference's lookup).
    """
    D = grad_out.shape[-1]
    bags = grad_out.reshape(-1, D).float()
    L = global_ids.numel() // max(bags.shape[0], 1)
    gid = global_ids.long()
    ok = (gid >= -num_rows) & (gid < num_rows)
    gid = torch.where(gid < 0, gid + num_rows, gid)
    src = bags[:, None, :].expand(bags.shape[0], L, D).reshape(-1, D)
    grad = torch.zeros((num_rows, D), dtype=torch.float32,
                       device=grad_out.device)
    return grad.index_add_(0, gid[ok], src[ok])


def batched_table_backward_window(grad_out: torch.Tensor,
                                  global_ids: torch.Tensor, lo: int,
                                  hi: int) -> torch.Tensor:
    """The gradient of :func:`batched_table_window_lookup` with respect to
    its table (the plain version of the backward's row window): grad_out
    (B, T, D) float32, global_ids (B*T*L,) -> (hi - lo, D) float32, bag b's
    gradient added into row id - lo of each of its ids in ``[lo, hi)``,
    any other id adding nothing."""
    D = grad_out.shape[-1]
    bags = grad_out.reshape(-1, D).float()
    L = global_ids.numel() // max(bags.shape[0], 1)
    local = global_ids.long() - lo
    ok = (local >= 0) & (local < hi - lo)
    src = bags[:, None, :].expand(bags.shape[0], L, D).reshape(-1, D)
    grad = torch.zeros((hi - lo, D), dtype=torch.float32,
                       device=grad_out.device)
    return grad.index_add_(0, local[ok], src[ok])


def _check_backward_inputs(grad_out, global_ids):
    """The backward kernels' checks; returns (num_bags, L, D)."""
    dev = grad_out.device
    if grad_out.dtype != torch.float32:
        raise TypeError(f"grad_out dtype {grad_out.dtype}: the backward "
                        "takes float32")
    if global_ids.dtype != torch.int32 or global_ids.device != dev:
        raise TypeError(f"global ids must be int32 on {dev}, got "
                        f"{global_ids.dtype} on {global_ids.device}")
    D = grad_out.shape[-1]
    if D * 4 % 16 or D * 4 > _MAX_ROW_BYTES:
        raise ValueError(f"rows of {D * 4} bytes: the kernel takes rows "
                         f"of a multiple of 16 bytes, at most "
                         f"{_MAX_ROW_BYTES}")
    if not (grad_out.is_contiguous() and global_ids.is_contiguous()):
        raise ValueError("grad_out and the ids must be contiguous")
    if grad_out.data_ptr() % 16:
        raise ValueError("grad_out must be 16-byte aligned")
    num_bags = grad_out.numel() // D
    L = global_ids.numel() // max(num_bags, 1)
    if num_bags * L != global_ids.numel():
        raise ValueError(f"{global_ids.numel()} ids for {num_bags} bags")
    return num_bags, L, D


class _EmbeddingBagOp:
    """BatchedTable embedding bag, chosen by the device of the table.

    CUDA: checks dtypes, shapes, devices, contiguity and alignment, forms
    the global ids ``indices + table_offsets[None, :, None]``, allocates
    the output with ``torch.empty``, launches on the current stream and
    adds one to :attr:`launches`.  The kernel checks the ids itself (no
    sync): ids in ``[-R, 0)`` wrap, a bag with an id outside ``[-R, R)``
    is NaN.  CPU: the plain :func:`batched_table_lookup`.  A table that
    requires grad goes through :class:`_EmbeddingBagFn` (same forward).
    """

    def __init__(self):
        self.launches = 0           # kernel launches, a plain integer

    def __call__(self, big_table, table_offsets, indices):
        if big_table.requires_grad and torch.is_grad_enabled():
            if big_table.dtype != torch.float32:
                raise TypeError(f"a {big_table.dtype} table that requires "
                                "grad: the backward takes float32 tables")
            return _EmbeddingBagFn.apply(big_table, table_offsets, indices)
        return self.forward(big_table, table_offsets, indices)

    def forward(self, big_table, table_offsets, indices):
        """The pooled bags, with no autograd graph."""
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


class _EmbeddingBagBackwardOp(KernelOp):
    """The backward of the embedding bag, chosen by the device of
    ``grad_out``: ``(grad_out (B, T, D) float32, global_ids (B*T*L,)
    int32, num_rows) -> grad_table (num_rows, D) float32``.

    CUDA: checks, zeroes the gradient (``torch.zeros``), launches
    ``batched_embedding_backward`` on the current stream and adds one to
    :attr:`launches`.  CPU: :func:`batched_table_backward`.
    """

    name = "batched_embedding_backward"

    def plain(self, grad_out, global_ids, num_rows):
        return batched_table_backward(grad_out, global_ids, num_rows)

    def prepare(self, grad_out, global_ids, num_rows) -> Launch:
        from repro_torch.kernels import batched_embedding as kernel

        dev = grad_out.device
        num_bags, L, D = _check_backward_inputs(grad_out, global_ids)
        grad = torch.zeros((num_rows, D), dtype=torch.float32, device=dev)
        if num_bags == 0:
            return Launch(None, (), grad, None)
        argv = (grad_out.data_ptr(), global_ids.data_ptr(), grad.data_ptr(),
                num_bags, L, D, num_rows,
                torch.cuda.current_stream(dev).cuda_stream)
        return Launch(kernel.library().batched_embedding_backward, argv,
                      grad, None)


class _EmbeddingBagBackwardWindowOp(KernelOp):
    """The backward's row window, chosen by the device of ``grad_out``:
    ``(grad_out (B, T, D) float32, global_ids (B*T*L,) int32, lo, hi) ->
    grad (hi - lo, D) float32``.  CUDA: checks, zeroes the gradient,
    launches ``batched_embedding_backward_window`` (the backward's
    instances with the window on) and adds one to :attr:`launches`; CPU:
    :func:`batched_table_backward_window`."""

    name = "batched_embedding_backward_window"

    def plain(self, grad_out, global_ids, lo, hi):
        return batched_table_backward_window(grad_out, global_ids, int(lo),
                                             int(hi))

    def prepare(self, grad_out, global_ids, lo, hi) -> Launch:
        from repro_torch.kernels import batched_embedding as kernel

        dev = grad_out.device
        lo, hi = int(lo), int(hi)
        if not 0 <= lo < hi:
            raise ValueError(f"window [{lo}, {hi})")
        num_bags, L, D = _check_backward_inputs(grad_out, global_ids)
        grad = torch.zeros((hi - lo, D), dtype=torch.float32, device=dev)
        if num_bags == 0:
            return Launch(None, (), grad, None)
        argv = (grad_out.data_ptr(), global_ids.data_ptr(), grad.data_ptr(),
                num_bags, L, D, lo, hi,
                torch.cuda.current_stream(dev).cuda_stream)
        return Launch(kernel.library().batched_embedding_backward_window,
                      argv, grad, None)


class _EmbeddingBagWindowOp(KernelOp):
    """The row-window embedding bag, ``(table, table_offsets, indices, lo,
    hi) -> pooled (B, T, D)``: CUDA launches ``batched_embedding_window``
    (the forward kernel's instances with the window on, so a launch
    without a window keeps its bits) and adds one to :attr:`launches`;
    CPU takes :func:`batched_table_window_lookup`."""

    name = "batched_embedding_window"

    def __call__(self, table, table_offsets, indices, lo, hi):
        if table.requires_grad and torch.is_grad_enabled():
            if table.dtype != torch.float32:
                raise TypeError(f"a {table.dtype} table that requires grad: "
                                "the backward takes float32 tables")
            return _EmbeddingBagWindowFn.apply(table, table_offsets, indices,
                                               int(lo), int(hi))
        return super().__call__(table, table_offsets, indices, lo, hi)

    def plain(self, table, table_offsets, indices, lo, hi):
        return batched_table_window_lookup(table, table_offsets, indices,
                                           int(lo), int(hi))

    def prepare(self, table, table_offsets, indices, lo, hi) -> Launch:
        from repro_torch.kernels import batched_embedding as kernel

        _check_cuda_inputs(table, table_offsets, indices)
        lo, hi = int(lo), int(hi)
        if not 0 <= lo < hi or hi - lo != table.shape[0]:
            raise ValueError(f"window [{lo}, {hi}) for a table of "
                             f"{table.shape[0]} rows")
        B, T, L = indices.shape
        D = table.shape[1]
        out = torch.empty((B, T, D), dtype=table.dtype, device=table.device)
        if B * T == 0:
            return Launch(None, (), out, None)
        global_ids = (indices + table_offsets[None, :, None]).reshape(-1)
        argv = (table.data_ptr(), global_ids.data_ptr(), out.data_ptr(),
                B * T, L, D, lo, hi, _DTYPES[table.dtype],
                torch.cuda.current_stream(table.device).cuda_stream)
        return Launch(kernel.library().batched_embedding_window, argv, out,
                      global_ids)


class _EmbeddingBagFn(torch.autograd.Function):
    """The embedding bag with the backward kernel as its gradient (the
    table's only: the offsets and ids get none)."""

    @staticmethod
    def forward(ctx, big_table, table_offsets, indices):
        ctx.num_rows = big_table.shape[0]
        ctx.save_for_backward(
            (indices + table_offsets[None, :, None]).reshape(-1))
        return embedding_bag.forward(big_table, table_offsets, indices)

    @staticmethod
    def backward(ctx, grad_out):
        (global_ids,) = ctx.saved_tensors
        grad = embedding_bag_backward(grad_out.contiguous(), global_ids,
                                      ctx.num_rows)
        return grad, None, None


class _EmbeddingBagWindowFn(torch.autograd.Function):
    """The row window with the backward's row window as its gradient (the
    table's only)."""

    @staticmethod
    def forward(ctx, table, table_offsets, indices, lo, hi):
        ctx.window = (lo, hi)
        ctx.save_for_backward(
            (indices + table_offsets[None, :, None]).reshape(-1))
        return embedding_bag_window(table, table_offsets, indices, lo, hi)

    @staticmethod
    def backward(ctx, grad_out):
        (global_ids,) = ctx.saved_tensors
        grad = embedding_bag_backward_window(grad_out.contiguous(),
                                             global_ids, *ctx.window)
        return grad, None, None, None, None


embedding_bag = _EmbeddingBagOp()
embedding_bag_backward = _EmbeddingBagBackwardOp()
embedding_bag_window = _EmbeddingBagWindowOp()
embedding_bag_backward_window = _EmbeddingBagBackwardWindowOp()
