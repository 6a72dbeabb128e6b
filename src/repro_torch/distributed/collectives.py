"""The port's collectives over a mesh axis: the one module that calls
``torch.distributed`` for a step's data.

A mesh (:class:`repro_torch.launch.mesh.Mesh`) names a process group per
axis of more than one rank; an axis of one rank has none, and every
collective over it is the identity.  The primitives, each on a tensor of
the caller's device (the sharded serving path takes the first three and
:func:`all_reduce_f32`):

* :func:`all_reduce`: SUM or MAX, in place, over the axis;
* :func:`all_gather`: the ranks' tensors concatenated along ``dim`` in
  rank order;
* :func:`broadcast`: rank ``src``'s tensor, in place, on every rank;
* :func:`reduce_scatter`, :func:`all_to_all`, :func:`reduce`: the rest
  of Fig 10's primitives (``repro_torch.bench.collectives``);
* :func:`all_reduce_f32`: SUM of a partial product taken in float32
  whatever the tensor's dtype, returned in that dtype.  The row-parallel
  products of the model (``wo``, ``w_down``) and the vocabulary-parallel
  lookups reduce through it: one card sums a product's terms in its float32
  accumulator and rounds once, and a float32 sum of the ranks' rounded
  partials stays within a rounding of that where a bfloat16 sum would
  round at every rank.

The process group's backend is whatever the caller initialised (gloo on
the CPU and for ranks that share a card, NCCL for ranks on separate
cards); this module never asks which.  Its name is read for reports
only (:func:`backend_name`).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

SUM = "sum"
MAX = "max"
_OPS = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX}


def _group(mesh, axis: str):
    return mesh.group(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str = "model",
               op: str = SUM) -> torch.Tensor:
    """``op`` (``"sum"`` or ``"max"``) of ``x`` over the axis, in place;
    returns ``x``."""
    if op not in _OPS:
        raise ValueError(f"all_reduce op {op!r}: expected {sorted(_OPS)}")
    group = _group(mesh, axis)
    if group is not None:
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_reduce_f32(x: torch.Tensor, mesh,
                   axis: str = "model") -> torch.Tensor:
    """SUM over the axis taken in float32, returned in ``x``'s dtype (a new
    tensor unless ``x`` is float32 and the axis has one rank)."""
    if _group(mesh, axis) is None:
        return x
    acc = x.float() if x.dtype != torch.float32 else x.clone()
    all_reduce(acc, mesh, axis)
    return acc.to(x.dtype)


def all_gather(x: torch.Tensor, mesh, axis: str = "model",
               dim: int = -1) -> torch.Tensor:
    """The axis's tensors (equal shapes) concatenated along ``dim`` in rank
    order."""
    group = _group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int, mesh,
              axis: str = "model") -> torch.Tensor:
    """Rank ``src`` (its index on the axis)'s ``x`` on every rank, in
    place; returns ``x``."""
    group = _group(mesh, axis)
    if group is not None:
        dist.broadcast(x, src=dist.get_global_rank(group, src)
                       if group is not dist.group.WORLD else src,
                       group=group)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axis: str = "model"
                   ) -> torch.Tensor:
    """SUM over the axis of ``x`` (its first dim a multiple of the axis
    size), this rank's block of the first dim."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = torch.empty((x.shape[0] // mesh.size(axis),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Block r of ``x``'s first dim to rank r; returns the blocks the ranks
    sent this one, in rank order."""
    group = _group(mesh, axis)
    if group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def reduce(x: torch.Tensor, dst: int, mesh, axis: str = "model",
           op: str = SUM) -> torch.Tensor:
    """``op`` over the axis into rank ``dst``'s ``x``, in place (the other
    ranks' ``x`` is left undefined); returns ``x``."""
    group = _group(mesh, axis)
    if group is not None:
        dist.reduce(x, dst=dist.get_global_rank(group, dst)
                    if group is not dist.group.WORLD else dst,
                    op=_OPS[op], group=group)
    return x


def barrier(mesh=None, axis: Optional[str] = "model") -> None:
    """Wait for the axis's ranks (every rank of the process group when
    ``mesh`` is None)."""
    if mesh is None:
        dist.barrier()
        return
    group = _group(mesh, axis)
    if group is not None:
        dist.barrier(group=group)


def backend_name(mesh, axis: str = "model") -> str:
    """The axis's process-group backend, for reports ("none": one rank)."""
    group = _group(mesh, axis)
    return "none" if group is None else str(dist.get_backend(group))
