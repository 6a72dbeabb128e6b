"""Serving meshes over ``torch.distributed`` ranks (port of
``repro.launch.mesh``), and the launcher that starts the ranks.

A :class:`Mesh` is the port's counterpart of a ``jax.sharding.Mesh``: its
axis names, its shape (axis name -> size, as ``dict(mesh.shape)`` reads in
the reference), this process's index on each axis, its device and a
process group per axis of more than one rank.  There is no single-process
stand-in for ranks: a mesh of S > 1 ranks needs S processes in one
initialised process group, which :func:`run_ranks` starts (gloo, a
``file://`` rendezvous in a temporary directory).  Each rank runs the same
host program on the same inputs; only the collectives of
:mod:`repro_torch.distributed.collectives` cross between them.

* :func:`make_serving_mesh`: the ``(1, model)`` mesh of the sharded
  serving engine, axes ``("data", "model")``.
* :func:`make_smoke_mesh`: a small ``(data, model)`` mesh over the ranks
  there are (the training mesh: FSDP over ``data``, TP and experts over
  ``model``);
* :func:`make_mesh`: ranks laid out row-major on any named axes (the
  pipeline's ``("pp",)``);
* :func:`data_axes`: the batch axes of a mesh.

``make_production_mesh`` (the dry run's 256- and 512-chip meshes) is left
for later (ROADMAP A10).
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """Ranks laid out row-major on named axes: rank r's coordinates are
    r's digits in the axes' sizes, the last axis fastest.  An axis of more
    than one rank has one process group per line of ranks along it (the
    ranks that agree on every other coordinate); this rank's is in
    ``groups``."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (``jax.lax.axis_index``)."""
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        """The process group of ``axis``; None for an axis of one rank."""
        return self.groups.get(axis) if self.size(axis) > 1 else None

    @property
    def devices(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= int(v)
        return n


def _current_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over the whole process group (its size the
    product of ``shape``; one process needs no group), as
    ``jax.make_mesh`` lays devices out.  Every rank must call it, and every
    rank creates every line's group in the same order, as
    ``torch.distributed.new_group`` asks; an axis that spans the whole
    group uses it as it is."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if n != world:
        raise ValueError(f"make_mesh: a {shape} mesh needs {n} ranks, the "
                         f"process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords, rest = {}, rank
    for name, size in reversed(list(zip(axis_names, shape))):
        coords[name] = rest % size
        rest //= size
    groups = {}
    for k, (name, size) in enumerate(zip(axis_names, shape)):
        if size == 1:
            continue
        if size == world:
            groups[name] = dist.group.WORLD
            continue
        stride = 1
        for s in shape[k + 1:]:
            stride *= s
        for start in range(world):
            if (start // stride) % size:
                continue                    # not the first of its line
            line = [start + i * stride for i in range(size)]
            group = dist.new_group(line)
            if rank in line:
                groups[name] = group
    return Mesh(axis_names=axis_names, shape=dict(zip(axis_names, shape)),
                coords={a: coords[a] for a in axis_names},
                device=_current_device(), groups=groups)


def _mesh(data: int, model: int) -> Mesh:
    return make_mesh((data, model), ("data", "model"))


def make_serving_mesh(model: int = 0) -> Mesh:
    """``(1, model)`` mesh of the sharded serving engine over this
    process group; ``model`` 0 means every rank.  A count the group cannot
    supply raises, as the reference's does when the host has fewer
    devices: serving on fewer ranks than asked would make every
    ``devices=`` number a lie.  A count below the group's size raises too
    (the port has no sub-mesh), and so does a count above 1 without an
    initialised group."""
    n = _world()
    if model > n:
        raise ValueError(
            f"make_serving_mesh: {model} model-axis ranks requested but the "
            f"process group has {n} (start the ranks with "
            "repro_torch.launch.mesh.run_ranks or torch.distributed)")
    model = n if model <= 0 else model
    if model != n:
        raise ValueError(
            f"make_serving_mesh: {model} model-axis ranks requested in a "
            f"process group of {n}; the port's serving mesh spans the group")
    return _mesh(1, model)


def make_smoke_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A tiny ``(data, model)`` mesh over the ranks there are (one,
    without a process group): ``data`` and ``model`` clamped as the
    reference clamps them to its devices.  The clamped mesh must cover the
    process group: the port has no idle ranks."""
    n = _world()
    data = min(data, n)
    model = min(model, n // data)
    if data * model != n:
        raise ValueError(f"make_smoke_mesh: a ({data}, {model}) mesh in a "
                         f"process group of {n}")
    return _mesh(data, model)


def sub_mesh(n: int) -> Mesh:
    """A ``(1, n)`` mesh over the group's first ``n`` ranks (every rank
    must call it, as ``torch.distributed.new_group`` asks); on the others
    its axis has one rank and no group."""
    world, rank = _world(), (dist.get_rank() if dist.is_initialized() else 0)
    if n > world:
        raise ValueError(f"sub_mesh: {n} ranks of a group of {world}")
    if n == world:
        return make_serving_mesh()
    group = dist.new_group(list(range(n)))
    inside = rank < n
    return Mesh(axis_names=("data", "model"),
                shape={"data": 1, "model": n if inside else 1},
                coords={"data": 0, "model": rank if inside else 0},
                device=_current_device(),
                groups={"model": group} if inside else {})


def data_axes(mesh: Mesh) -> tuple:
    """Batch-sharding axes for a mesh (includes 'pod' when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


# ------------------------------------------------------------ rank launcher
def _rank_main(rank: int, n: int, rdv: str, results, fn: Callable,
               args: tuple, device_type: str) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:       # n ranks share the host's cores: one thread each
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=n)
        out = fn(*args)
        results.put((rank, "ok", out))
        from repro_torch.distributed import collectives
        collectives.barrier()       # every rank is done before any leaves
        dist.destroy_process_group()
    except BaseException:                                    # noqa: BLE001
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(fn: Callable, n: int, args: tuple = (), *,
              device: str = "cpu", timeout: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` fresh processes joined in one gloo
    process group (rank r on ``cuda:(r % device_count)`` when ``device``
    is a card); returns the ``n`` results in rank order.  ``fn`` must be a
    module-level function (the processes are spawned).  A rank that raises
    ends the call with ``RuntimeError`` carrying its traceback; a run past
    ``timeout`` seconds ends it with ``TimeoutError``.  Every process is
    stopped before this returns or raises."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, rdv, results, fn, args,
                                   device_type))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: {n - len(out)} of {n} ranks gave no "
                        f"result in {timeout:.0f} s")
                try:
                    rank, status, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"run_ranks: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if status == "error":
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(n)]
