"""Paper Fig 15: SingleTable vs BatchedTable embedding-lookup time (port of
``benchmarks/embedding_tables.py``).

SingleTable gathers and pools each table in its own launches
(``embedding_api.single_table_lookup``); BatchedTable pools every table in
one launch of the hand-written kernel (``embedding_api.embedding_bag``; its
plain version on the CPU).  Sweeps the number of tables, the batch and the
vector width (the paper's three axes) at pooling factor L = 20 and 4096
rows per table, float32.  Each row carries ``launches=`` (gathers per call;
the batched one counted from the kernel wrapper) and the batched row
``speedup_vs_single=``.

    python -m repro_torch.bench.embedding_tables [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import REPS, WARMUP, device_name, emit, time_ms
from repro_torch.core import embedding_api

ROWS = 4_096
L = 20                                      # pooling factor (RM2)
DIMS, TABLES, BATCHES = (16, 64, 128, 256), (1, 4, 10, 20, 40), (
    4, 16, 64, 256, 1024)


def run(device="cuda", dims: Sequence[int] = DIMS,
        tables: Sequence[int] = TABLES, batches: Sequence[int] = BATCHES
        ) -> List[Dict[str, object]]:
    """Time every (D, T, B) point, SingleTable then BatchedTable; returns
    the rows printed."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    where = f"device={device_name(dev)}"
    op = embedding_api.embedding_bag
    rows: List[Dict[str, object]] = []
    for D in dims:
        for T in tables:
            big = torch.randn((T * ROWS, D), generator=gen, device=dev)
            offs = torch.arange(T, dtype=torch.int32, device=dev) * ROWS
            tabs = [big[t * ROWS:(t + 1) * ROWS] for t in range(T)]
            for B in batches:
                idx = torch.randint(0, ROWS, (B, T, L), generator=gen,
                                    device=dev, dtype=torch.int32)
                ms_s = time_ms(embedding_api.single_table_lookup, tabs, idx,
                               device=dev)
                before = op.launches
                ms_b = time_ms(op, big, offs, idx, device=dev)
                launches = (op.launches - before) / (WARMUP + REPS)
                rows.append(emit(f"embed_single_T{T}_B{B}_D{D}", ms_s,
                                 f"launches={T};{where}"))
                rows.append(emit(
                    f"embed_batched_T{T}_B{B}_D{D}", ms_b,
                    f"launches={launches:g};speedup_vs_single="
                    f"{ms_s / max(ms_b, 1e-9):.2f};{where}"))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
