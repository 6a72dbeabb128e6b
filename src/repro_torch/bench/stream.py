"""Paper Fig 8 / Alg 1: STREAM ADD, SCALE and TRIAD through the port's
CUDA kernels, with the tile-height sweep (port of ``benchmarks/stream.py``).

``block_rows`` (the tile height, in rows of 128 elements) is the
granularity knob the reference swept as its BlockSpec tile height; the
port's kernel runs a grid sized to the card whatever it is and cuts its
16 KiB units at tile boundaries (``kernels/csrc/stream.cu``).  Each
measured row prints the wrapper's time per call (``ms``: the median of
per-call CUDA events, host work included), the bytes the op must move (3 n
elt for ADD and TRIAD, 2 n elt for SCALE), its operations, their ratio and
the H100
roofline's time (``bench.common.roofline_ms``); on the card also the
kernel's own time (``kernel_ms``, back-to-back launches through the C
entry point) and the GB/s it reaches with its share of the 3.35 TB/s, in
place of the reference's TPU DMA-efficiency formula.  Each also prints its
bytes beside the card's 50 MB L2 and carries ``in_l2``
(``H100.fits_in_l2`` of its bytes): the reference's full size (n = 2^21
float32, 24 MiB for ADD) fits in the L2, so such a row prints ``in_l2``
and no share of the HBM's rate, and a run that means to measure HBM
passes a larger ``n`` (STREAM's rule: each array at least four times the
last-level cache).  The operational-intensity
rows (Fig 8 d-f) are predictions of the H100 roofline, as the reference's
were of its own, and print no time.

    python -m repro_torch.bench.stream [--device cpu] [--full] [--n N]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import (CALLS, device_name, emit, kernel_ms,
                                      rates, roofline_ms, time_ms)
from repro_torch.kernels.stream import ops
from repro_torch.roofline.analysis import H100, time_model

N = {True: 128 * 1024, False: 128 * 16384}     # the reference's sizes
ROWS = {True: (8, 64, 256), False: (8, 16, 64, 256, 1024)}
OI_REPEATS = (1, 8, 64, 512)


def run(device="cuda", quick: bool = True, n: Optional[int] = None,
        dtype: torch.dtype = torch.float32) -> List[Dict[str, object]]:
    """The block_rows sweep (ADD), the three ops at block_rows 256 and the
    predicted intensity rows; returns the rows printed.  Kernel rows carry
    ``op`` (the wrapper), ``calls`` (its calls) and ``launches`` (what its
    count rose by)."""
    dev = device_lib.resolve(device)
    n = n or N[quick]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    a = torch.randn(n, generator=gen, device=dev).to(dtype)
    b = torch.randn(n, generator=gen, device=dev).to(dtype)
    elt = a.element_size()
    where = f"device={device_name(dev)}"
    rows: List[Dict[str, object]] = []

    def measured(name, op, args, block_rows, flops, nbytes):
        before = op.launches
        ms = time_ms(op, *args, block_rows, device=dev)
        launches = op.launches - before
        k_ms = kernel_ms(op, *args, block_rows, device=dev)
        in_l2 = H100.fits_in_l2(nbytes)
        row = emit(name, ms, f"n={n};block_rows={block_rows};bytes={nbytes};"
                   f"l2_bytes={H100.l2_bytes:.0f};flops={flops};"
                   f"ai={flops / nbytes:.3f};h100_roofline_ms="
                   f"{roofline_ms(flops, nbytes, dtype):.6g}"
                   + (f";kernel_ms={k_ms:.6g}" if k_ms is not None else "")
                   + f"{rates(k_ms, flops, nbytes, in_l2)};{where}")
        row.update(op=op.name, n=n, block_rows=block_rows, bytes=nbytes,
                   flops=flops, calls=CALLS, launches=launches,
                   kernel_ms=k_ms, in_l2=in_l2)
        rows.append(row)

    for block_rows in ROWS[quick]:
        measured(f"stream_add_rows{block_rows}", ops.stream_add, (a, b),
                 block_rows, n, 3 * elt * n)
    for name, op, args, traffic, flops in (
            ("stream_add", ops.stream_add, (a, b), 3 * elt * n, n),
            ("stream_scale", ops.stream_scale, (a, 3.0), 2 * elt * n, n),
            ("stream_triad", ops.stream_triad, (a, b, 3.0), 3 * elt * n,
             2 * n)):
        measured(name, op, args, 256, flops, traffic)
    # operational-intensity saturation (Fig 8 d-f): the compute repeated k
    # times over the same bytes, predicted from the H100 roofline
    for k in OI_REPEATS:
        flops, traffic = 2 * n * k, 3 * elt * n
        t = time_model(flops, traffic, dtype)
        rows.append(emit(
            f"stream_triad_oi{k}", 0.0,
            f"predicted;h100_roofline_ms={1e3 * t:.6g};h100_util="
            f"{flops / t / H100.peak(dtype):.3f};ai={flops / traffic:.1f}"))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--n", type=int, default=None,
                    help="elements per array (a multiple of 128 x 1024)")
    args = ap.parse_args(argv)
    run(args.device, quick=not args.full, n=args.n)


if __name__ == "__main__":
    main()
