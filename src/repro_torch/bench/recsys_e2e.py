"""Paper Fig 11 / Table 3: end-to-end DLRM-DCNv2 inference latency, RM1
(compute-heavy) and RM2 (memory-heavy), BatchedTable vs SingleTable, over a
batch sweep (port of ``benchmarks/recsys_e2e.py``).

Each row is one forward at one batch: its median time (``bench.common.
time_ms``), and the operations and bytes counted from the shapes
(:func:`forward_cost`).  Random weights come from a seeded generator on
the device, batches from ``SyntheticRecSysDataset``.

Energy is measured, not modelled: on a card the rows at the largest
batch of the sweep carry ``energy_uJ_per_inf`` (microjoules a sample) and ``watts``, read from the
card's energy counter (``bench.energy``) over a loop of forwards of at
least 2 s.  The idle power is not taken off.  The reference's estimate,
from constants for a TPU-class part, is not carried over; on the CPU the
rows have no energy key.

    python -m repro_torch.bench.recsys_e2e [--device cpu] [--rows N]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import (REPS, WARMUP, device_name, emit,
                                      time_ms)
from repro_torch.config import DLRMConfig, get_config
from repro_torch.data.pipeline import SyntheticRecSysDataset
from repro_torch.models.api import build_model

ARCHS = ("rm1", "rm2")
# (rows per table, batches): the reference's full sizes (the configs' full
# width) and its quick ones
SIZES = {False: (1_000_000, (16, 64, 256, 1024, 4096)),
         True: (10_000, (64,))}


def forward_cost(cfg: DLRMConfig, batch: int) -> Tuple[float, float]:
    """(operations, bytes) of one float32 forward at ``batch``.

    Operations: 2 per multiply-add of the MLPs and cross layers, one per
    element pooled, three per element of each cross layer's update.  Bytes:
    every weight once, the rows gathered, the int32 ids, the dense input
    and the logits; activations between layers are not counted.
    """
    B, T, L, D = (batch, cfg.num_tables, cfg.gathers_per_table,
                  cfg.embedding_dim)
    d, r = cfg.bottom_mlp[-1] + T * D, cfg.cross_rank
    macs = weights = 0
    for dims in ((cfg.dense_features,) + cfg.bottom_mlp,
                 (d,) + cfg.top_mlp):
        for a, b in zip(dims[:-1], dims[1:]):
            macs += a * b
            weights += a * b + b
    macs += cfg.cross_layers * 2 * d * r
    weights += cfg.cross_layers * (2 * d * r + d)
    ops = 2 * B * macs + B * T * L * D + cfg.cross_layers * 3 * B * d
    nbytes = 4 * (weights + B * T * L * D + B * T * L
                  + B * cfg.dense_features + B)
    return float(ops), float(nbytes)


def run(device="cuda", quick: bool = False, rows: Optional[int] = None,
        archs: Sequence[str] = ARCHS,
        batches: Optional[Sequence[int]] = None,
        energy: bool = True) -> List[Dict[str, object]]:
    """Time every (arch, batch) forward, SingleTable then BatchedTable, at
    the reference's ``quick`` or full sizes where ``rows`` or ``batches``
    is not given; on a card and with ``energy``, read the energy of the
    largest batch over 2 s loops.

    Returns one dict per row: ``name``, ``ms``, ``derived``, and ``arch``,
    ``batch``, ``use_batched``, ``calls`` (forwards run, timed or not),
    ``finite`` (the last forward's logits are finite) and ``shape``; a row
    with an energy reading also ``energy_uJ_per_inf``, ``watts`` and
    ``energy_s``.
    """
    dev = device_lib.resolve(device)
    rows = rows or SIZES[quick][0]
    batches = batches or SIZES[quick][1]
    energy_at = max(batches) if energy and dev.type == "cuda" else None
    counter = None
    if energy_at is not None:
        from repro_torch.bench import energy as energy_lib
        counter = energy_lib.EnergyCounter(dev)
    where = f"device={device_name(dev)}"
    out: List[Dict[str, object]] = []
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), num_embeddings=rows)
        models = {ub: build_model(cfg, device=dev, use_batched=ub)
                  for ub in (False, True)}
        params = models[True].init(0)
        for B in batches:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     SyntheticRecSysDataset(cfg, B).batch_at(0).items()}
            flops, nbytes = forward_cost(cfg, B)
            ms = {}
            for ub, model in models.items():
                ms[ub] = time_ms(model.forward, params, batch, device=dev)
                logits = model.forward(params, batch)
                tag = "batched" if ub else "single"
                derived = f"flops={flops:.4g};bytes={nbytes:.4g};{where}"
                if ub:
                    derived += (f";speedup_vs_single="
                                f"{ms[False] / max(ms[True], 1e-9):.2f}")
                calls = WARMUP + REPS + 1
                joules = {}
                if B == energy_at:
                    reading = energy_lib.measure(
                        lambda: model.forward(params, batch), counter, dev)
                    calls += reading["calls"] + 1   # + its warm-up call
                    joules = dict(energy_uJ_per_inf=reading["joules"]
                                  / (reading["calls"] * B) * 1e6,
                                  watts=reading["watts"],
                                  energy_s=reading["seconds"])
                    derived += (f";energy_uJ_per_inf="
                                f"{joules['energy_uJ_per_inf']:.3f}"
                                f";watts={joules['watts']:.1f}")
                row = emit(f"recsys_{arch}_{tag}_B{B}", ms[ub], derived)
                row.update(joules)
                row.update(arch=arch, batch=B, use_batched=ub,
                           calls=calls,
                           finite=bool(torch.isfinite(logits).all()),
                           shape=tuple(logits.shape))
                out.append(row)
        del params, models
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=SIZES[False][0],
                    help="rows per embedding table")
    args = ap.parse_args(argv)
    run(args.device, rows=args.rows)


if __name__ == "__main__":
    main()
