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

The training step's collectives are differentiable
(``torch.distributed``'s are not, and ``torch.distributed.nn``'s
``all_reduce`` sums again in its backward): each is a
``torch.autograd.Function`` whose backward is the conjugate collective.

* :func:`gather_shards`: FSDP's gather of leaves split over an axis, in
  one all-gather; its backward reduce-scatters (SUM) their gradients, and
  all-reduces those of the leaves the axis does not split (the data
  parallel SUM), in one collective each;
* :func:`copy_to` and :func:`reduce_from` (Megatron's f and g): the
  identity forward with a SUM backward, and a SUM forward (float32, or
  exact) with the identity backward;
* :func:`gather_replicated`: an all-gather whose consumer is replicated
  over the axis, so its gradient is whole on every rank and its backward
  keeps this rank's block;
* :func:`all_to_all_f`: the all-to-all, its own inverse, so its backward is
  an all-to-all of the gradient;
* :func:`shift`: each rank's tensor to the next rank of the axis (the
  pipeline's stage boundary; forward only);
* :func:`all_reduce_int32`: the exact integer SUM of int8 values, widened
  to int32 (gradient compression).

The process group's backend is whatever the caller initialised (gloo on
the CPU and for ranks that share a card, NCCL for ranks on separate
cards); this module asks which only where gloo cannot carry a CUDA
tensor (:func:`shift`), and for reports (:func:`backend_name`).

On an ABSTRACT mesh (``repro_torch.launch.mesh.make_production_mesh``:
one rank's coordinates on the dry run's 256- or 512-chip meshes, no
process group) nothing is sent: a collective over an axis of more than one
rank takes meta tensors only (a real tensor raises), returns its result's
shape (a gather multiplies the dim by the axis size, a reduce-scatter
divides it, the rest keep it) and, inside :func:`counting`, adds its
operand bytes to the tally of its kind: the reference's
``collective_bytes_from_hlo`` sums the operand bytes of every
``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all`` and
``collective-permute`` of a device's program, which is what one rank's
eager step calls here.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

SUM = "sum"
MAX = "max"
_OPS = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX}

# the reference's kinds (repro.roofline.analysis._COLLECTIVES)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_tally: Optional[Dict[str, float]] = None
# the collectives this process has sent, by kind: plain integers a caller
# may read (``bench.sharded_steps`` prints a step's)
calls: Dict[str, int] = dict.fromkeys(KINDS, 0)


Axes = Union[str, Tuple[str, ...]]


def _group(mesh, axis: str):
    return mesh.group(axis)


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, float]]:
    """A tally, by kind and ``"total"``, of the operand bytes of the
    collectives called over an abstract mesh inside the block (module
    docstring); nested blocks each keep their own."""
    global _tally
    prev = _tally
    _tally = dict.fromkeys(KINDS + ("total",), 0.0)
    try:
        yield _tally
    finally:
        _tally = prev


def _counted(mesh, axis: str, x: torch.Tensor, kind: str) -> bool:
    """True where the mesh is abstract: the collective is counted (its
    operand ``x``'s bytes, over an axis of more than one rank) and not
    run.  A real tensor there raises: an abstract axis is never taken for
    one rank."""
    if not getattr(mesh, "abstract", False):
        return False
    if x.device.type != "meta":
        raise RuntimeError(
            f"{kind} over axis {axis!r} of an abstract mesh on a "
            f"{x.device.type} tensor: an abstract mesh only counts, on "
            "meta tensors")
    if mesh.size(axis) > 1 and _tally is not None:
        nbytes = float(x.numel() * x.element_size())
        _tally[kind] += nbytes
        _tally["total"] += nbytes
    return True


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str = "model",
               op: str = SUM) -> torch.Tensor:
    """``op`` (``"sum"`` or ``"max"``) of ``x`` over the axis, in place;
    returns ``x``."""
    if op not in _OPS:
        raise ValueError(f"all_reduce op {op!r}: expected {sorted(_OPS)}")
    if _counted(mesh, axis, x, "all-reduce"):
        return x
    group = _group(mesh, axis)
    if group is not None:
        calls["all-reduce"] += 1
        dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_reduce_f32(x: torch.Tensor, mesh,
                   axis: str = "model") -> torch.Tensor:
    """SUM over the axis taken in float32, returned in ``x``'s dtype (a new
    tensor unless ``x`` is float32 and the axis has one rank)."""
    if mesh.size(axis) == 1:
        return x
    acc = x.float() if x.dtype != torch.float32 else x.clone()
    all_reduce(acc, mesh, axis)
    return acc.to(x.dtype)


def all_gather(x: torch.Tensor, mesh, axis: str = "model",
               dim: int = -1) -> torch.Tensor:
    """The axis's tensors (equal shapes) concatenated along ``dim`` in rank
    order."""
    if _counted(mesh, axis, x, "all-gather"):
        shape = list(x.shape)
        shape[dim] *= mesh.size(axis)
        return x.new_empty(shape)
    group = _group(mesh, axis)
    if group is None:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x)
                                 for _ in range(mesh.size(axis))]
    calls["all-gather"] += 1
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(x: torch.Tensor, src: int, mesh,
              axis: str = "model") -> torch.Tensor:
    """Rank ``src`` (its index on the axis)'s ``x`` on every rank, in
    place; returns ``x``."""
    if _counted(mesh, axis, x, "collective-permute"):
        return x
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
    if _counted(mesh, axis, x, "reduce-scatter"):
        return x.new_empty((x.shape[0] // mesh.size(axis),)
                           + tuple(x.shape[1:]))
    group = _group(mesh, axis)
    if group is None:
        return x
    out = torch.empty((x.shape[0] // mesh.size(axis),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    calls["reduce-scatter"] += 1
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Block r of ``x``'s first dim to rank r; returns the blocks the ranks
    sent this one, in rank order."""
    if _counted(mesh, axis, x, "all-to-all"):
        return x.new_empty(x.shape)
    group = _group(mesh, axis)
    if group is None:
        return x
    out = torch.empty_like(x)
    calls["all-to-all"] += 1
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def reduce(x: torch.Tensor, dst: int, mesh, axis: str = "model",
           op: str = SUM) -> torch.Tensor:
    """``op`` over the axis into rank ``dst``'s ``x``, in place (the other
    ranks' ``x`` is left undefined); returns ``x``."""
    if _counted(mesh, axis, x, "all-reduce"):
        return x
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
    if getattr(mesh, "abstract", False):
        return
    group = _group(mesh, axis)
    if group is not None:
        dist.barrier(group=group)


def backend_name(mesh, axis: str = "model") -> str:
    """The axis's process-group backend, for reports ("none": one rank;
    "abstract": an abstract mesh)."""
    if getattr(mesh, "abstract", False):
        return "abstract"
    group = _group(mesh, axis)
    return "none" if group is None else str(dist.get_backend(group))


# ------------------------------------------------- differentiable collectives
class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, dims, replicated, *shards):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, dims
        ctx.replicated = replicated
        ctx.shapes = [tuple(t.shape) for t in shards]
        n = mesh.size(axis)
        split = [i for i, d in enumerate(dims) if d is not None]
        out = list(shards)
        for dtype in dict.fromkeys(shards[i].dtype for i in split):
            same = [i for i in split if shards[i].dtype == dtype]
            flat = torch.cat([shards[i].reshape(-1) for i in same])
            parts = all_gather(flat, mesh, axis, dim=0).view(n, -1)
            at = 0
            for i in same:
                size = shards[i].numel()
                blocks = parts[:, at:at + size].reshape(
                    (n,) + ctx.shapes[i])
                out[i] = torch.cat(blocks.unbind(0), dim=dims[i])
                at += size
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axis, dims = ctx.mesh, ctx.axis, ctx.dims
        n = mesh.size(axis)
        out = list(grads)
        split = [i for i, d in enumerate(dims) if d is not None]
        whole = [i for i, d in enumerate(dims) if d is None]
        if ctx.replicated:          # every rank's gradient is the whole one
            lo = mesh.axis_index(axis)
            for i in split:
                size = ctx.shapes[i][dims[i]]
                out[i] = grads[i].narrow(dims[i], lo * size, size)
            return (None, None, None, None, *out)
        if split:
            # rank r's row: every split leaf's block r, flattened
            rows = torch.cat([torch.stack(grads[i].float().chunk(
                n, dim=dims[i])).reshape(n, -1) for i in split], dim=1)
            mine = reduce_scatter(rows.contiguous().view(-1), mesh, axis)
            at = 0
            for i in split:
                size = _numel(ctx.shapes[i])
                out[i] = mine[at:at + size].view(ctx.shapes[i]).to(
                    grads[i].dtype)
                at += size
        if whole:
            flat = torch.cat([grads[i].float().reshape(-1) for i in whole])
            all_reduce(flat, mesh, axis)
            at = 0
            for i in whole:
                size = _numel(ctx.shapes[i])
                out[i] = flat[at:at + size].view(ctx.shapes[i]).to(
                    grads[i].dtype)
                at += size
        return (None, None, None, None, *out)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def gather_shards(shards: Sequence[torch.Tensor],
                  dims: Sequence[Optional[int]], mesh,
                  axis: str = "data", *,
                  replicated: bool = False) -> List[torch.Tensor]:
    """FSDP's gather over ``axis``: each ``shards[i]`` with ``dims[i]`` set
    is this rank's block of a leaf split on that dim, and comes back whole
    (the ranks' blocks in rank order), all of them in ONE all-gather a
    dtype (a float32 router beside bfloat16 experts keeps its own: one
    buffer would widen every leaf to float32); a leaf with ``dims[i]``
    None is whole already and comes back as it is.
    Backward: the split leaves' gradients reduce-scattered (SUM) in one
    collective, the whole leaves' all-reduced (SUM) in one, in float32,
    each returned in its leaf's dtype: the data-parallel SUM of the
    ranks' gradients.  An axis of one rank is the identity both ways.

    ``replicated``: the whole leaves feed a computation that every rank of
    the axis runs alike, so each rank's gradient is already the whole one:
    backward keeps this rank's block of a split leaf's gradient and passes
    a whole leaf's on as it is (no collective)."""
    if mesh.size(axis) == 1:
        return list(shards)
    return list(_GatherShards.apply(mesh, axis, tuple(dims), replicated,
                                    *shards))


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for a in ctx.axes:
            all_reduce(g, ctx.mesh, a)
        return g, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, f32):
        for a in axes:
            x = (all_reduce_f32(x, mesh, a) if f32
                 else all_reduce(x.clone(), mesh, a))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def copy_to(x: torch.Tensor, mesh, axis: Axes = "model") -> torch.Tensor:
    """Megatron's f: ``x`` (whole on every rank of ``axis``) as it is,
    before a computation split over the axis; backward: the SUM of the
    ranks' partial gradients.  An axis of one rank is the identity."""
    axes = tuple(a for a in _axes(axis) if mesh.size(a) > 1)
    if not axes or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axis: Axes = "model", *,
                f32: bool = True) -> torch.Tensor:
    """Megatron's g: the SUM of the ranks' ``x`` over ``axis`` (taken in
    float32 and returned in ``x``'s dtype with ``f32``, else summed as it
    is: exact where one rank holds each value and the others zeros, or for
    integers); backward: the identity (the consumer is replicated over the
    axis, so every rank's gradient is already whole)."""
    axes = tuple(a for a in _axes(axis) if mesh.size(a) > 1)
    if not axes:
        return x
    return _ReduceFrom.apply(x, mesh, axes, f32)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.axis_index(ctx.axis) * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size), None, None, None


def gather_replicated(x: torch.Tensor, mesh, axis: str = "model",
                      dim: int = -1) -> torch.Tensor:
    """:func:`all_gather` of this rank's block along ``dim`` for a consumer
    replicated over the axis: backward keeps this rank's block of the
    (whole, equal on every rank) gradient."""
    if mesh.size(axis) == 1:
        return x
    return _GatherReplicated.apply(x, mesh, axis, dim % x.dim())


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_to_all_f(x: torch.Tensor, mesh, axis: str = "model"
                 ) -> torch.Tensor:
    """:func:`all_to_all` with a gradient: block r of the first dim to rank
    r, the blocks received in rank order.  It is its own inverse, so the
    backward sends the gradient's blocks back the same way."""
    if mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)


def shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Rank i's ``x`` on rank i + 1 of the axis (``jax.lax.ppermute`` with
    the pairs (i, i + 1)); rank 0 gets zeros, the last rank's ``x`` goes
    nowhere.  Point to point, every pair at once
    (``batch_isend_irecv``).  gloo sends and receives host tensors only,
    so a CUDA tensor is staged through pinned host memory on a gloo group
    (a copy each way, timed by ``chip_smoke.py`` phase 48d)."""
    if _counted(mesh, axis, x, "collective-permute"):
        return torch.zeros_like(x)
    group = _group(mesh, axis)
    if group is None:
        return torch.zeros_like(x)
    i, n = mesh.axis_index(axis), mesh.size(axis)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.detach().contiguous()
    if staged:
        send = torch.empty(send.shape, dtype=send.dtype,
                           pin_memory=True).copy_(send)
    recv = torch.zeros(send.shape, dtype=send.dtype, device=send.device,
                       pin_memory=staged)
    ops = []
    peer = (lambda j: j if group is dist.group.WORLD
            else dist.get_global_rank(group, j))
    if i + 1 < n:
        ops.append(dist.P2POp(dist.isend, send, peer(i + 1), group))
    if i > 0:
        ops.append(dist.P2POp(dist.irecv, recv, peer(i - 1), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


def all_reduce_int32(q: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The exact SUM over the axis of integer values (int8 included),
    widened to int32 first (ranks x 127 stays far below 2^31); an int32
    ``q`` is summed in place."""
    return all_reduce(q.to(torch.int32), mesh, axis)
