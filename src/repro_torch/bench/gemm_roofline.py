"""Paper Fig 4/5/7: bf16 GEMM over square and irregular shapes against the
H100 roofline (port of ``benchmarks/gemm_roofline.py``).

The product is ``torch.matmul``, as the reference leaves ``a @ b`` to XLA
outside any Pallas kernel.  Each row prints the operations and bytes of
the shape, their ratio, the roofline's prediction (TFLOP/s and which bound
applies) and, on the card, the device time over back-to-back calls
(``device_ms``; ``ms`` is the median per call, host work included), the
TFLOP/s it reaches and its share of the 989 TFLOP/s bf16 peak.  The reference's MXU 128-padding ``util`` is TPU
geometry and does not carry over.

    python -m repro_torch.bench.gemm_roofline [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import (device_ms, device_name, emit,
                                      roofline_ms, time_ms)
from repro_torch.roofline.analysis import H100, bound_by

SQUARES = {True: (256, 512, 1024), False: (256, 512, 1024, 2048, 4096, 8192)}
IRREGULAR = ((2048, 2048, 16), (4096, 4096, 16))


def shapes_for(quick: bool) -> List[Tuple[int, int, int]]:
    return [(s, s, s) for s in SQUARES[quick]] + list(IRREGULAR)


def run(device="cuda", quick: bool = True,
        shapes: Optional[Sequence[Tuple[int, int, int]]] = None
        ) -> List[Dict[str, object]]:
    """One row per (M, K, N); returns the rows printed."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dtype = torch.bfloat16
    where = f"device={device_name(dev)}"
    rows: List[Dict[str, object]] = []
    for M, K, N in shapes or shapes_for(quick):
        a = torch.randn((M, K), generator=gen, device=dev).to(dtype)
        b = torch.randn((K, N), generator=gen, device=dev).to(dtype)
        ms = time_ms(torch.matmul, a, b, device=dev)
        flops = 2.0 * M * K * N
        nbytes = 2.0 * (M * K + K * N + M * N)
        t_ms = roofline_ms(flops, nbytes, dtype)
        derived = (f"flops={flops:.6g};bytes={nbytes:.6g};"
                   f"ai={flops / nbytes:.1f};h100_roofline_ms={t_ms:.6g};"
                   f"h100_tflops_pred={flops / t_ms / 1e9:.1f};"
                   f"bound={bound_by(flops, nbytes, dtype)}")
        d_ms = device_ms(torch.matmul, a, b, device=dev)
        if d_ms is not None:
            tflops = flops / d_ms / 1e9
            derived += (f";device_ms={d_ms:.6g};tflops={tflops:.1f};"
                        f"peak_share={tflops * 1e12 / H100.peak_bf16:.3f}")
        row = emit(f"gemm_{M}x{K}x{N}", ms, f"{derived};{where}")
        row.update(shape=(M, K, N), flops=flops, bytes=nbytes,
                   roofline_ms=t_ms, device_ms=d_ms)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    run(args.device, quick=not args.full)


if __name__ == "__main__":
    main()
