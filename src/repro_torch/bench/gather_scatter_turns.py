"""Two or more source trees of the port on one card, in turns: their row
gather and scatter kernels (paper Fig 9) on the same inputs.

    PYTHONPATH=src python -m repro_torch.bench.gather_scatter_turns \
        --trees OLD NEW [--order 0110]

``OLD`` and ``NEW`` are roots of checkouts of the repo (say a parent commit
unpacked with ``git archive`` into a git-ignored directory, and this tree);
more trees may follow, each named in ``--order`` by its index.  Each turn
(default parent, change, change, parent) is a process that imports
``repro_torch`` from that tree's ``src`` (its kernels build into that
tree's ``build/``; the runner is :mod:`repro_torch.bench.turns`) and
prints one JSON line:

* ``rows``: Fig 9's twelve calls on ``chip_smoke.py`` phase 24's inputs
  (:func:`fig9_inputs`: 4 M float32 rows of 16 to 2048 bytes, 1 M uniform
  ids, about 115 k of them repeats), each first held bitwise against its
  plain version, then the kernel's ms (CUDA events over back-to-back
  launches through the C entry point); ``sweep_ms`` is their sum;
* ``profile``: device ms per launch of each kernel of one gather and one
  scatter call at 16 and 2048 bytes (:func:`launch_profile`).

The first turn on the last tree also prints ``probe`` (:func:`probe`):
``index_copy_`` on distinct ids at 16- and 32-byte rows, which asks
whether a random 16-byte write costs the card more than half a 32-byte
one (the scatter's sector bound counts a fill read for each partly
written sector on that answer), and the 16-byte gather over tables from
inside the L2 to 1 GB.

Every number comes from the card; without one the script exits nonzero.
The script imports from each tree only what every tree has (the
gather/scatter wrappers and ``bench.common``), so it can time an older
one.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

FIG9_R, FIG9_N = 4_000_000, 1_000_000
FIG9_BYTES = (16, 64, 128, 256, 512, 2048)
PROFILED_BYTES = (16, 2048)
PROFILE_TRIES = 3
# (R, N) of the write probe: Fig 9's, and one whose written sectors
# (4 M x 32 B = 128 MB) do not fit in the 50 MB L2
PROBE_SIZES = ((FIG9_R, FIG9_N), (16_000_000, 4_000_000))
# table rows of the narrow gather probe: 16 MB (inside the L2) to 1 GB
NARROW_R = (1_000_000, FIG9_R, 64_000_000)


def fig9_inputs(torch, dev):
    """Yields ``(row_bytes, table, src, idx)`` for each Fig 9 width: the
    tensors ``chip_smoke.py`` phase 24 times (seed 6, drawn in this
    order)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for vb in FIG9_BYTES:
        table = torch.randn((FIG9_R, vb // 4), generator=gen, device=dev)
        src = torch.randn((FIG9_N, vb // 4), generator=gen, device=dev)
        idx = torch.randint(0, FIG9_R, (FIG9_N,), generator=gen, device=dev,
                            dtype=torch.int32)
        yield vb, table, src, idx


def launch_profile(torch, fn, calls: int = 5) -> dict:
    """Device ms per launch of each kernel or memset that ``fn()``
    launches, by name, under ``torch.profiler`` over ``calls`` calls
    (after one untimed call), and the launches of each that the profiler
    recorded per call (it may miss some).  A session that records no
    device activity at all (one of a run's profiled calls on an H100 did)
    is taken again, up to :data:`PROFILE_TRIES` sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            name = ("memset" if "memset" in e.key.lower() else
                    (re.findall(r"(\w+)[<(]", e.key) or [e.key])[0])
            if us > 0:
                out[name] = dict(ms=us / e.count / 1e3,
                                 per_call=e.count / calls)
        if out:
            return out
    raise AssertionError(f"the profiler saw no device activity in "
                         f"{PROFILE_TRIES} sessions")


def probe(torch, dev, device_ms, kernel_ms, ops) -> dict:
    """ms per call, back-to-back calls: ``index_copy_`` on N distinct ids
    into an R-row table, 16-byte rows at ids drawn from all R rows (two may
    share a 32-byte sector), 16-byte rows one per sector (even ids only)
    and 32-byte rows, each at the two :data:`PROBE_SIZES`; then the
    gather's kernel at 16-byte rows and Fig 9's N over tables of
    :data:`NARROW_R` rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    out = {}
    for R, N in PROBE_SIZES:
        any_row = torch.randperm(R, generator=gen, device=dev)[:N]
        own_sector = 2 * torch.randperm(R // 2, generator=gen,
                                        device=dev)[:N]
        for name, vb, ids in (("16B", 16, any_row),
                              ("16B_one_per_sector", 16, own_sector),
                              ("32B", 32, any_row)):
            table = torch.zeros((R, vb // 4), device=dev)
            src = torch.randn((N, vb // 4), generator=gen, device=dev)
            out[f"index_copy_{name}_R{R}_N{N}"] = device_ms(
                lambda: table.index_copy_(0, ids, src), device=dev, reps=50)
            del table, src
    for R in NARROW_R:
        table = torch.randn((R, 4), generator=gen, device=dev)
        idx = torch.randint(0, R, (FIG9_N,), generator=gen, device=dev,
                            dtype=torch.int32)
        out[f"gather_16B_R{R}"] = kernel_ms(ops.vector_gather, table, idx,
                                            device=dev, reps=50)
        del table, idx
    return out


def measure(with_probe: bool) -> None:
    """One turn on the tree ``repro_torch`` was imported from."""
    import torch
    from repro_torch.bench.common import device_ms, kernel_ms
    from repro_torch.kernels.gather_scatter import ops

    dev = torch.device("cuda")
    rows, profile = {}, {}
    for vb, table, src, idx in fig9_inputs(torch, dev):
        for key, op, args in (("gather", ops.vector_gather, (table, idx)),
                              ("scatter", ops.vector_scatter_,
                               (table, idx, src))):
            got = op(table.clone(), *args[1:])
            want = op.plain(table.clone(), *args[1:])
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise AssertionError(f"{key} {vb} B: kernel != plain")
            del got, want
            rows[f"{key}_{vb}B"] = kernel_ms(op, *args, device=dev, reps=50)
            if vb in PROFILED_BYTES:
                profile[f"{key}_{vb}B"] = launch_profile(
                    torch, lambda: op(*args))
        del table, src
    row = {"device": torch.cuda.get_device_name(0), "rows": rows,
           "sweep_ms": sum(rows.values()), "profile": profile}
    if with_probe:
        row["probe"] = probe(torch, dev, device_ms, kernel_ms, ops)
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--order", default="0110")
    # a turn's process: "probe" measures and then probes
    ap.add_argument("--worker", choices=("measure", "probe"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gather_scatter_turns: no CUDA card")
    if args.worker:
        measure(args.worker == "probe")
        return 0
    from repro_torch.bench import turns

    probe_turn = args.order.find(str(len(args.trees) - 1))
    turns.run(str(Path(__file__).resolve()), args.trees, args.order,
              lambda turn, tree: [
                  "--worker", "probe" if turn == probe_turn else "measure",
                  "--trees", str(tree)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
