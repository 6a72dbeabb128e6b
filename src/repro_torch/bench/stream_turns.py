"""Two or more source trees of the port on one card, in turns: their STREAM
kernels (paper Fig 8) on the same inputs.

    PYTHONPATH=src python -m repro_torch.bench.stream_turns \
        --trees OLD NEW [--order 0110]

``OLD`` and ``NEW`` are roots of checkouts of the repo (say a parent commit
unpacked with ``git archive`` into a git-ignored directory, and this
tree); more trees may follow, each named in ``--order`` by its index (the
runner is :mod:`repro_torch.bench.turns`).  Each turn is a process on one
tree that prints one JSON line whose ``rows`` hold, for float32 and
bfloat16 at n = 2^21 (the reference's Fig 8 size, inside the 50 MB L2) and
2^28 (1 GiB per float32 array): ADD at every ``block_rows`` of Fig 8's
sweep (:data:`SWEEP`) and SCALE and TRIAD at 256.  Each call is first
held bitwise against its plain version, then timed two ways, both in ms
per launch through the C entry point (the wrapper's host work and its
launch count left out):

* ``kernel_ms``: CUDA events over back-to-back launches
  (``bench.common.kernel_ms``, as ``chip_smoke.py`` phases 22 and 24);
* ``graph_ms``: CUDA events over a CUDA graph of :data:`GRAPH_LAUNCHES`
  launches, the median of :data:`GRAPH_REPLAYS` replays, which leaves the
  host's launch time out where it is near the kernel's (the 2^21 rows).

``library`` holds the same two times of the ``torch`` call that computes
each op (``torch.add`` / ``mul`` / ``add(alpha=)``) on the same tensors,
``bound_ms`` the bytes each op must move at 3.35 TB/s, and ``plan`` the
grid each row launched where the tree's library reports it
(``stream_plan``).  Every number comes from the card; without one the
script exits nonzero.  A worker imports from each tree only what every
tree has (the STREAM wrappers and ``bench.common``), so it can time an
older one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

N = {"2^21": 2 ** 21, "2^28": 2 ** 28}
SWEEP = (8, 16, 64, 256, 1024)
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 5
HBM_BYTES_PER_S = 3.35e12


def graph_ms(torch, make) -> float:
    """ms per call of ``make()()`` from a CUDA graph of
    :data:`GRAPH_LAUNCHES` calls (captured after one untimed call), the
    median over :data:`GRAPH_REPLAYS` timed replays.  ``make`` is called
    once outside the capture and once inside it, so what it prepares
    lands on the capturing stream."""
    make()()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn = make()
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    return sorted(times)[len(times) // 2]


def launcher(op, args):
    """A call of ``op``'s kernel through its C entry point, prepared when
    it is first called, on the stream that is current then."""
    box = []

    def go():
        if not box:
            box.append(op.prepare(*args))
        launch = box[0]
        err = launch.fn(*launch.argv)
        if err != 0:
            raise RuntimeError(f"{op.name} kernel launch failed: {err}")

    return go


def measure() -> None:
    """One turn on the tree ``repro_torch`` was imported from."""
    import torch
    from repro_torch.bench.common import device_ms, kernel_ms
    from repro_torch.kernels.stream import ops

    try:                        # trees before the persistent grid lack it
        from repro_torch.kernels.stream import plan
    except ImportError:
        plan = None
    dev = torch.device("cuda")
    rows, library, bounds, plans = {}, {}, {}, {}
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for nname, n in N.items():
            gen = torch.Generator(device=dev)
            gen.manual_seed(8)
            a = torch.randn(n, generator=gen, device=dev).to(dtype)
            b = torch.randn(n, generator=gen, device=dev).to(dtype)
            s = 3.0
            calls = [("add", ops.stream_add, (a, b), r) for r in SWEEP] + [
                ("scale", ops.stream_scale, (a, s), 256),
                ("triad", ops.stream_triad, (a, b, s), 256)]
            for name, op, args, block_rows in calls:
                key = f"{dname}_{nname}_{name}_r{block_rows}"
                got = op(*args, block_rows)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int16),
                                   op.plain(*args, block_rows).view(
                                       torch.int16)):
                    raise AssertionError(f"{key}: kernel != plain")
                del got
                rows[key] = dict(
                    kernel_ms=kernel_ms(op, *args, block_rows, device=dev),
                    graph_ms=graph_ms(torch, lambda: launcher(
                        op, (*args, block_rows))))
                if plan is not None:
                    plans[key] = plan(("add", "scale", "triad").index(name),
                                      n, block_rows, int(dname == "bf16"))
            for name, fn, arrays in (
                    ("add", lambda: torch.add(a, b), 3),
                    ("scale", lambda: torch.mul(a, s), 2),
                    ("triad", lambda: torch.add(b, a, alpha=s), 3)):
                key = f"{dname}_{nname}_{name}"
                library[key] = dict(
                    kernel_ms=device_ms(fn, device=dev),
                    graph_ms=graph_ms(torch, lambda: fn))
                bounds[key] = 1e3 * arrays * n * a.element_size() \
                    / HBM_BYTES_PER_S
            del a, b
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows,
                      "library": library, "bound_ms": bounds,
                      "plan": plans}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--order", default="0110")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("stream_turns: no CUDA card")
    if args.worker:
        measure()
        return 0
    from repro_torch.bench import turns

    turns.run(str(Path(__file__).resolve()), args.trees, args.order,
              lambda turn, tree: ["--worker", "--trees", str(tree)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
