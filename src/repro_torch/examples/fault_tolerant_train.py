"""Fault-tolerant training demo (port of the reference's
``examples/fault_tolerant_train.py``): checkpoint, simulated crash,
restore, continue, with straggler detection and an elastic remesh plan.

    python -m repro_torch.examples.fault_tolerant_train              # card
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train --device cpu
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticLMDataset
from repro_torch.distributed.elastic import (
    HeartbeatMonitor, StragglerWatchdog, plan_remesh)
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.training.train_step import init_state, make_train_step
from repro_torch.training.trainer import Trainer


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    cfg = get_config("smollm-360m").reduced(dtype="float32", num_layers=2,
                                            vocab_size=512)
    model = build_model(cfg, device=args.device, remat=False)
    opt = adamw()
    step = make_train_step(model, opt, cosine_warmup(1e-3, 2, 40))
    ds = SyntheticLMDataset(cfg.vocab_size, 32, 4)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ft_") as ckpt_dir:
        cm = CheckpointManager(ckpt_dir, keep=2)

        # phase 1: train 10 steps, checkpointing every 5
        p1 = DataPipeline(ds)
        t1 = Trainer(step_fn=step, state=init_state(model, 0, opt),
                     pipeline=p1, ckpt=cm, checkpoint_every=5,
                     watchdog=StragglerWatchdog(threshold=3.0))
        s1 = t1.run(10)
        p1.close()
        print(f"phase 1: loss {s1['final_loss']:.4f}, "
              f"{s1['straggler_steps']} stragglers, ckpt at "
              f"{cm.latest_step()}")

        # simulated node failure: coordinator notices a dead host
        hb = HeartbeatMonitor(list(range(4)), timeout_s=1.0)
        hb.beat(0, now=100.0); hb.beat(1, now=100.0)  # noqa: E702
        hb.beat(2, now=100.0); hb.beat(3, now=90.0)  # noqa: E702
        dead = hb.dead(now=101.5)
        print(f"heartbeat: dead hosts {dead}")
        plan = plan_remesh(512 - 256, 256, model_parallel=16)
        print(f"elastic remesh plan after pod loss: {plan}")

        # phase 2: a fresh trainer restores from the checkpoint, continues
        p2 = DataPipeline(ds, start_step=cm.latest_step())
        t2 = Trainer(step_fn=step, state=init_state(model, 99, opt),
                     pipeline=p2, ckpt=cm)
        resumed = t2.maybe_restore()
        s2 = t2.run(5)
        p2.close()
    print(f"phase 2: resumed from step {resumed}, loss "
          f"{s2['final_loss']:.4f}")
    assert resumed == 10


if __name__ == "__main__":
    main()
