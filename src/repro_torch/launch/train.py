"""Training launcher of the port: ``python -m repro_torch.launch.train
--arch smollm-360m --steps 50 --batch 8 --seq 256`` runs a real training
loop on one device: AdamW with a cosine warm-up, synthetic token batches
through the prefetching pipeline, the trainer with its straggler
watchdog and, with ``--ckpt-dir``, async checkpoints (``--resume``
restores the latest).  The flags are the reference's
(``repro.launch.train``) plus ``--device``.  As in the reference the step
is ``jit_train_step`` on ``make_smoke_mesh()`` with ``ShardingRules(mesh,
head_dim=)``: one rank here, whose step is the one-device step (a mesh of
ranks is built by ``launch.mesh.run_ranks`` callers, as the tests and
``chip_smoke.py`` phase 48 do).

Weights are random, from a seeded generator on the device.  Pass
``--device cpu`` (with ``--reduced`` for a tiny model) to run the plain
PyTorch path without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticLMDataset
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.training.train_step import (
    abstract_state, init_state, jit_train_step)
from repro_torch.training.trainer import Trainer


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--reduced", action="store_true",
                   help="use the smoke-scale config (CPU-friendly)")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (the plain path)")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype=args.dtype)
    else:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg, device=args.device)
    mesh = make_smoke_mesh()
    attn = getattr(cfg, "attention", None)
    rules = ShardingRules(mesh, head_dim=attn.head_dim if attn else None)
    opt = adamw()
    lr_fn = cosine_warmup(args.lr, max(args.steps // 10, 1), args.steps)

    state = init_state(model, 0, opt)
    batch_shape = {"tokens": torch.empty((args.batch, args.seq),
                                         dtype=torch.int32, device="meta")}
    step = jit_train_step(model, opt, lr_fn, mesh, rules,
                          abstract_state(model, opt), batch_shape)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, args.batch)
    pipe = DataPipeline(ds)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(step_fn=step, state=state, pipeline=pipe, ckpt=ckpt,
                      metrics_hook=lambda i, r: print(
                          f"step {i:5d}  loss {r['loss']:.4f}  "
                          f"{r['dt']*1e3:.0f} ms"))
    if args.resume:
        start = trainer.maybe_restore()
        print(f"resumed from step {start}")
    t0 = time.time()
    try:
        summary = trainer.run(args.steps)
    finally:
        pipe.close()
    print(f"done in {time.time()-t0:.1f}s: {summary}")
    return summary


if __name__ == "__main__":
    main()
