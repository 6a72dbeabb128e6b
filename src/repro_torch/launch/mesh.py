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
* :func:`run_ranks`: a job on ``n`` gloo ranks (a :class:`RankPool`,
  closed after the job, or kept inside :func:`rank_pools`);
* :func:`make_production_mesh`: the dry run's 256- and 512-chip meshes,
  ABSTRACT: one rank's coordinates (rank 0's) and no process group, for
  counting a step on the meta device (``repro_torch.distributed.
  collectives`` counts, and does not send, over it);
* :func:`data_axes`: the batch axes of a mesh.
"""
from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """Ranks laid out row-major on named axes: rank r's coordinates are
    r's digits in the axes' sizes, the last axis fastest.  An axis of more
    than one rank has one process group per line of ranks along it (the
    ranks that agree on every other coordinate); this rank's is in
    ``groups``.  An ``abstract`` mesh has no processes and no groups: its
    collectives are counted, on meta tensors only, never sent."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    groups: Dict[str, Any] = field(default_factory=dict)
    abstract: bool = False

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        """This rank's index on ``axis`` (``jax.lax.axis_index``)."""
        return int(self.coords.get(axis, 0))

    def group(self, axis: str):
        """The process group of ``axis``; None for an axis of one rank.
        An abstract mesh's axis of more than one rank has none and raises:
        it must never pass for one rank."""
        if self.size(axis) == 1:
            return None
        if self.abstract:
            raise RuntimeError(f"axis {axis!r} of an abstract mesh has no "
                               "process group (it counts, on meta tensors)")
        return self.groups.get(axis)

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract: ``(16, 16)`` on
    ``("data", "model")`` (256 chips), or ``(2, 16, 16)`` on ``("pod",
    "data", "model")`` (512, two pods) with ``multi_pod``, seen from rank
    0, on the meta device.  For counting one rank's step
    (``repro_torch.launch.dryrun``); a collective over it on a real tensor
    raises."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def abstract_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...]
                  ) -> Mesh:
    """An abstract mesh of ``shape`` on ``axis_names``, seen from rank 0 on
    the meta device: no processes, no groups; its collectives count, on
    meta tensors only (``jax.sharding.AbstractMesh``'s counterpart)."""
    axes = tuple(axis_names)
    return Mesh(axis_names=axes, shape=dict(zip(axes, map(int, shape))),
                coords=dict.fromkeys(axes, 0), device=torch.device("meta"),
                abstract=True)


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
def _collect(results, procs, n: int, timeout: float) -> List[Any]:
    """The ``n`` ranks' results from ``results`` in rank order; raises on a
    rank's error, on a rank that exited without one, and past
    ``timeout``."""
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    while len(out) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"run_ranks: {n - len(out)} of {n} ranks "
                               f"gave no result in {timeout:.0f} s")
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
            raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
        out[rank] = value
    return [out[r] for r in range(n)]


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(fn: Callable, n: int, args: tuple = (), *,
              device: str = "cpu", timeout: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` processes joined in one gloo process
    group (rank r on ``cuda:(r % device_count)`` when ``device`` is a
    card); returns the ``n`` results in rank order.  ``fn`` must be a
    module-level function (the processes are spawned).  A rank that raises
    ends the call with ``RuntimeError`` carrying its traceback; a run past
    ``timeout`` seconds ends it with ``TimeoutError``.  Outside
    :func:`rank_pools` the ranks are a :class:`RankPool` of this one job,
    closed (every process stopped) before this returns or raises; inside,
    an idle pool's, kept for the next call."""
    device_type = torch.device(device).type
    pool = _take_pool(n, device_type)
    if pool is not None:
        return pool.run(fn, args, timeout)
    pool = RankPool(n, device_type)
    try:
        return pool.run(fn, args, timeout)
    finally:
        pool.close()


# ------------------------------------------------------------ rank pools
def _pool_main(rank: int, n: int, rdv: str, jobs, results,
               device_type: str) -> None:
    """A pool's rank: joins the group once, then runs each ``(fn, args)``
    of ``jobs`` until None; after each job its memory is freed, the
    float32 matmul flags are put back as they were, and every rank meets
    at a barrier.  A job that raises ends the rank."""
    import gc

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=n)
    except BaseException:                                    # noqa: BLE001
        results.put((rank, "error", traceback.format_exc()))
        return
    from repro_torch.distributed import collectives
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, "ok", fn(*args)))
        except BaseException:                                # noqa: BLE001
            results.put((rank, "error", traceback.format_exc()))
            return
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
        gc.collect()
        if device_type == "cuda":
            torch.cuda.empty_cache()
        collectives.barrier()       # every rank is done before the next
    collectives.barrier()
    dist.destroy_process_group()


class RankPool:
    """``n`` rank processes joined in one gloo group once, each running
    job after job (:func:`run_ranks`'s contract: the results in rank
    order, a rank's error or a timeout raised).  What a spawn costs (the
    processes, each rank's import and device context, the group) is paid
    once for every call.  A job that fails leaves the pool closed."""

    def __init__(self, n: int, device_type: str):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.device_type = n, device_type
        self.busy = False
        self._tmp = tempfile.TemporaryDirectory(prefix="repro_torch_pool_")
        rdv = os.path.join(self._tmp.name, "rendezvous")
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(target=_pool_main,
                                  args=(r, n, rdv, self.jobs[r],
                                        self.results, device_type))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.closed = False

    def run(self, fn: Callable, args: tuple, timeout: float) -> List[Any]:
        try:
            for q in self.jobs:
                q.put((fn, args))
            return _collect(self.results, self.procs, self.n, timeout)
        except BaseException:
            self.close(abort=True)
            raise
        finally:
            self.busy = False

    def close(self, abort: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        if not abort:
            for q in self.jobs:
                q.put(None)
            for p in self.procs:
                p.join(timeout=60)
        _stop(self.procs)
        self._tmp.cleanup()


_pools: Optional[Dict[Tuple[int, str], List[RankPool]]] = None
_pools_lock = threading.Lock()


def _take_pool(n: int, device_type: str) -> Optional[RankPool]:
    """Inside :func:`rank_pools`: an idle open pool of ``n`` ranks on
    ``device_type`` (a new one when every such pool is busy), marked busy;
    None outside."""
    with _pools_lock:
        if _pools is None:
            return None
        pools = _pools.setdefault((n, device_type), [])
        pools[:] = [p for p in pools if not p.closed]
        pool = next((p for p in pools if not p.busy), None)
        if pool is None:
            pool = RankPool(n, device_type)
            pools.append(pool)
        pool.busy = True
        return pool


@contextlib.contextmanager
def rank_pools() -> Iterator[None]:
    """Inside the block, :func:`run_ranks` runs its jobs on kept rank
    processes: a :class:`RankPool` for each rank count and device, started
    on first use (two calls at once, from two threads, get a pool each),
    all closed at the end.  Jobs then share their ranks' processes, so a
    job must not rely on what another left behind."""
    global _pools
    with _pools_lock:
        if _pools is not None:
            raise RuntimeError("rank_pools: already inside one")
        _pools = {}
    try:
        yield
    finally:
        with _pools_lock:
            pools, _pools = _pools, None
        for group in pools.values():
            for pool in group:
                pool.close(abort=pool.busy)
