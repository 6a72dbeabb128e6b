"""Train DLRM-DCNv2 (RM2) end to end with the BatchedTable embedding path
(port of the reference's ``examples/train_dlrm.py``): the paper's §4.1
technique inside a full training loop, its backward through the
hand-written backward kernel on a card.

    python -m repro_torch.examples.train_dlrm                       # card
    PYTHONPATH=src python -m repro_torch.examples.train_dlrm --device cpu

Gradients are taken over the float leaves only (``table_offsets`` is
int32); the reference's ``jax.value_and_grad`` over the whole tree raises
there at jax 0.9 (ROADMAP queue C).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import get_config
from repro_torch.data.pipeline import DataPipeline, SyntheticRecSysDataset
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import apply_updates
from repro_torch.training.train_step import loss_and_grads


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(get_config("rm2"), num_embeddings=5_000)
    model = build_model(cfg, device=args.device, use_batched=True)
    params = model.init(0)
    opt = adamw(weight_decay=0.0)
    state = opt.init(params)

    def step(params, state, batch):
        loss, grads = loss_and_grads(model.loss, params, batch)
        upd, state, _ = opt.update(grads, state, params, 1e-3)
        return apply_updates(params, upd), state, loss

    pipe = DataPipeline(SyntheticRecSysDataset(cfg, 256))
    t0 = time.time()
    first = last = None
    try:
        for i in range(30):
            _, batch = next(pipe)
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in batch.items()}
            params, state, loss = step(params, state, batch)
            if i == 0:
                first = float(loss)
            last = float(loss)
            if i % 10 == 0:
                print(f"step {i:3d}  bce {float(loss):.4f}")
    finally:
        pipe.close()
    print(f"30 steps in {time.time()-t0:.1f}s; loss {first:.4f} -> "
          f"{last:.4f}")
    assert last < first
    return first, last


if __name__ == "__main__":
    main()
