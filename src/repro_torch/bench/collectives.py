"""Paper Fig 10: collective-communication time and bus utilisation, six
primitives x group sizes n in {2, 4, 8} x message sizes (port of
``benchmarks/collectives.py``).

Rows are the reference's: ``coll_{prim}_n{n}_{size}B`` with the derived
bus-utilisation models of its Fig 10 argument, an all-to-all switch
(NVSwitch: flat), P2P pairwise links (Gaudi-2: proportional to the links
a group of n uses of 7) and a TPU 2D-torus ICI (flat), each times the
primitive's NCCL bus factor.  ``us`` is measured where the process group
has at least n ranks and is 0.0 beyond (the reference's rule for its host
devices): the median over ``iters`` calls after two warm-ups, each call
on a buffer of ``size / n`` bytes a rank (the reference shards one
``size``-byte array over the n devices), timed on the host clock between
two barriers, the card synchronised before each reading.

Each row also names what the time is: ``backend`` (the process group's),
``ranks`` (n) and ``ranks_per_card`` (how many of the n ranks share one
card; ``None`` on the CPU).  A gloo group whose ranks share one card moves
every collective through host memory, so its times say nothing of NVLink.
A primitive the backend refuses for the buffers' device gives a row with
``refused`` set to the error and ``us`` 0.0; nothing is staged through the
host in its place.  ``reduce`` and ``broadcast`` are the real primitives
(root 0), where the reference times ``psum`` and ``all_gather`` for them.

    python -m repro_torch.bench.collectives --ranks 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

PRIMS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "reduce", "broadcast")
GROUPS = (2, 4, 8)
QUICK_SIZES = (2_048, 1 << 20, 32 << 20)
FULL_SIZES = (2_048, 65_536, 1 << 20, 8 << 20, 32 << 20)


def bus_factor(prim: str, n: int) -> float:
    """NCCL bus-bandwidth convention: algbw -> busbw factor."""
    if prim == "all_reduce":
        return 2 * (n - 1) / n
    if prim in ("all_gather", "reduce_scatter", "all_to_all"):
        return (n - 1) / n
    return 1.0


def derived(prim: str, n: int) -> str:
    """The reference's derived string of a row."""
    switch = 1.0                      # NVSwitch: flat
    p2p = (n - 1) / max(8 - 1, 1)     # Gaudi P2P: proportional to links used
    torus = min(1.0, 4 / 4)           # ICI ring: flat (4 links)
    bf = bus_factor(prim, n)
    return (f"bus_util_switch={switch*bf:.2f};"
            f"bus_util_p2p={p2p*bf:.2f};bus_util_ici={torus*bf:.2f}")


def primitive(prim: str, x: torch.Tensor, mesh) -> torch.Tensor:
    """One call of ``prim`` on this rank's ``x`` over the mesh's axis."""
    from repro_torch.distributed import collectives as c

    if prim == "all_reduce":
        return c.all_reduce(x, mesh)
    if prim == "all_gather":
        return c.all_gather(x, mesh, dim=0)
    if prim == "reduce_scatter":
        return c.reduce_scatter(x, mesh)
    if prim == "all_to_all":
        return c.all_to_all(x, mesh)
    if prim == "reduce":
        return c.reduce(x, 0, mesh)
    return c.broadcast(x, 0, mesh)


def expected(prim: str, n: int, rank: int, numel: int,
             dtype=torch.float32) -> Optional[torch.Tensor]:
    """What ``prim`` leaves on ``rank`` when rank r's buffer holds
    ``r + 1 + arange(numel)`` (None where nothing is defined: a reduce's
    non-root); small integers, exact in bfloat16 too."""
    base = torch.arange(numel, dtype=dtype)
    mine = [r + 1 + base for r in range(n)]
    if prim == "all_reduce":
        return sum(mine)
    if prim == "all_gather":
        return torch.cat(mine)
    if prim == "reduce_scatter":
        step = numel // n
        return sum(mine)[rank * step:(rank + 1) * step]
    if prim == "all_to_all":
        step = numel // n
        return torch.cat([m[rank * step:(rank + 1) * step] for m in mine])
    if prim == "reduce":
        return sum(mine) if rank == 0 else None
    return mine[0]


def check_job(device: str = "cpu", numel: int = 64,
              dtypes=("float32",)) -> Dict[str, bool]:
    """Rank job: each primitive on a small known input in each of
    ``dtypes``, held to :func:`expected` exactly ({"prim/dtype": bool}); a
    primitive the backend refuses raises."""
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh()
    n, r = mesh.size("model"), mesh.axis_index("model")
    out = {}
    for dtype in dtypes:
        dt = getattr(torch, dtype)
        for prim in PRIMS:
            x = (r + 1 + torch.arange(numel, dtype=dt)).to(device)
            got = primitive(prim, x, mesh)
            want = expected(prim, n, r, numel, dt)
            out[f"{prim}/{dtype}"] = want is None or torch.equal(got.cpu(),
                                                                 want)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_job(device: str = "cpu", quick: bool = True, iters: int = 5,
             sizes=None) -> List[Dict[str, object]]:
    """Rank job: Fig 10's rows as this rank times them (rank 0's are the
    report).  Every rank takes part in every timed call."""
    from repro_torch.distributed import collectives as c
    from repro_torch.launch.mesh import make_serving_mesh, sub_mesh

    world = make_serving_mesh()
    dev = torch.device(device)
    max_n = world.size("model")
    backend = c.backend_name(world)
    per_card = (max(1, max_n // max(torch.cuda.device_count(), 1))
                if dev.type == "cuda" else None)
    sizes = sizes or (QUICK_SIZES if quick else FULL_SIZES)
    meshes = {n: (sub_mesh(n) if n <= max_n and n > 1 else None)
              for n in GROUPS}
    rows = []
    for prim in PRIMS:
        for n in GROUPS:
            mesh = meshes[n]
            for size in sizes:
                us, refused = 0.0, None
                if mesh is not None:
                    numel = max(n, size // 4 // n // n * n)
                    x = torch.zeros((numel,), dtype=torch.float32,
                                    device=dev)
                    inside = mesh.size("model") == n
                    times = []
                    try:
                        for i in range(2 + iters):
                            _sync(dev)
                            c.barrier(world)
                            t0 = time.perf_counter()
                            if inside:
                                primitive(prim, x, mesh)
                                _sync(dev)
                            c.barrier(world)
                            if i >= 2:
                                times.append(time.perf_counter() - t0)
                        times.sort()
                        us = times[len(times) // 2] * 1e6
                    except RuntimeError as e:
                        refused = f"{type(e).__name__}: {str(e)[:160]}"
                        us = 0.0
                rows.append(dict(
                    name=f"coll_{prim}_n{n}_{size}B", us=us,
                    derived=derived(prim, n),
                    backend=backend if mesh is not None else None,
                    ranks=n, ranks_per_card=per_card if mesh is not None
                    else None, refused=refused))
    return rows


def run(device="cuda", quick: bool = True, ranks: int = 2,
        iters: int = 5, timeout: float = 900.0) -> List[Dict[str, object]]:
    """The module's rows, timed on ``ranks`` gloo ranks started here
    (``ms`` beside the reference's ``us``); on a card every rank takes
    ``cuda:(r % device_count)``."""
    from repro_torch.launch.mesh import run_ranks

    rows = run_ranks(time_job, ranks, (str(device), quick, iters),
                     device=device, timeout=timeout)[0]
    for r in rows:
        r["ms"] = r["us"] / 1e3
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.bench.collectives")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--full", action="store_true")
    args = p.parse_args(argv)
    from repro_torch import device as device_lib
    device_lib.resolve(args.device)
    print("name,us,derived,backend,ranks_per_card,refused")
    for r in run(args.device, quick=not args.full, ranks=args.ranks):
        print(f"{r['name']},{r['us']:.1f},{r['derived']},{r['backend']},"
              f"{r['ranks_per_card']},{r['refused'] or ''}")


if __name__ == "__main__":
    main()
