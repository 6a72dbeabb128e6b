"""Paper Fig 9: GUPS-style random row gather and scatter, swept over the
row width, through the port's CUDA kernels (port of
``benchmarks/gather_scatter.py``).

For each row width (16 to 2048 bytes, float32) a table of R rows, N ids
drawn uniformly (so some repeat) and N source rows: the gather
(``vector_gather``) and the in-place scatter (``vector_scatter_``), then
``index_select`` and ``index_copy_`` on the same inputs, timed as a
yardstick and used nowhere in the port.  Each row prints the wrapper's
time per call (``ms``, host work included), the bytes the op must move
(gather: the distinct table rows read, N rows written and the ids;
scatter: the winning source row of each distinct target read, the
distinct target rows written and the ids; a repeated id's row need be
moved once) and the H100 roofline's
time; on the card also the kernel's own time (``kernel_ms``, back-to-back
launches through the C entry point), the useful GB/s it reaches with its
share of the 3.35 TB/s; the yardstick's time (``library_ms``) is taken over
back-to-back calls on the card, per call on the CPU.  The reference's TPU tile-waste formula does not carry over.
The H100's analogue is the 32-byte sector, the least the memory system
moves for a scattered access: ``sector_eff`` is the share of the sectors
touched that a row fills (a 16-byte row half-fills one), a prediction
printed beside the measurement.

    python -m repro_torch.bench.gather_scatter [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import (CALLS, device_ms, device_name, emit,
                                      kernel_ms, rates, roofline_ms, time_ms)
from repro_torch.kernels.gather_scatter import ops

SIZES = {True: (65_536, 8_192), False: (4_000_000, 1_000_000)}   # (R, N)
VEC_BYTES = (16, 64, 128, 256, 512, 2048)
SECTOR = 32


def run(device="cuda", quick: bool = True, R: Optional[int] = None,
        N: Optional[int] = None, vec_bytes: Sequence[int] = VEC_BYTES
        ) -> List[Dict[str, object]]:
    """Gather and scatter at each row width; returns the rows printed.
    Rows carry ``op``, ``calls`` and ``launches`` (what the wrapper's
    count rose by), ``library_ms``, and on the card ``kernel_ms``."""
    dev = device_lib.resolve(device)
    R = R or SIZES[quick][0]
    N = N or SIZES[quick][1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    where = f"device={device_name(dev)}"
    rows: List[Dict[str, object]] = []
    for vb in vec_bytes:
        D = max(vb // 4, 1)
        table = torch.randn((R, D), generator=gen, device=dev)
        src = torch.randn((N, D), generator=gen, device=dev)
        idx = torch.randint(0, R, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        idx_long = idx.long()
        distinct = torch.unique(idx).numel()
        sector_eff = vb / (-(-vb // SECTOR) * SECTOR)
        for name, op, args, nbytes, library in (
                ("gather", ops.vector_gather, (table, idx),
                 distinct * vb + N * vb + 4 * N,
                 lambda: torch.index_select(table, 0, idx)),
                ("scatter", ops.vector_scatter_, (table, idx, src),
                 2 * distinct * vb + 4 * N,
                 lambda: table.index_copy_(0, idx_long, src))):
            before = op.launches
            ms = time_ms(op, *args, device=dev)
            launches = op.launches - before
            k_ms = kernel_ms(op, *args, device=dev)
            library_ms = (device_ms(library, device=dev) if k_ms is not None
                          else time_ms(library, device=dev))
            row = emit(f"{name}_{vb}B", ms,
                       f"R={R};N={N};distinct={distinct};bytes={nbytes};"
                       f"h100_roofline_ms="
                       f"{roofline_ms(0, nbytes, torch.float32):.6g};"
                       f"sector_eff={sector_eff:.2f};library_ms="
                       f"{library_ms:.6g}"
                       + (f";kernel_ms={k_ms:.6g}" if k_ms is not None else "")
                       + f"{rates(k_ms, 0, nbytes)};{where}")
            row.update(op=op.name, vec_bytes=vb, R=R, N=N, bytes=nbytes,
                       distinct=distinct, kernel_ms=k_ms,
                       library_ms=library_ms, calls=CALLS, launches=launches)
            rows.append(row)
        del table, src
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    run(args.device, quick=not args.full)


if __name__ == "__main__":
    main()
