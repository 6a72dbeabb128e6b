"""Trainer loop (port of ``repro.training.trainer``): data pipeline +
train step + async checkpoints + straggler watchdog + restore.

Each numpy batch from the pipeline goes to the device of the state's
parameters; a restored leaf goes to the device, and into the dtype, of
the leaf it replaces.  ``float(metrics["loss"])`` is the step's one sync
point, as in the reference.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed.elastic import StragglerWatchdog
from repro_torch.training.train_step import TrainState


def _place(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x).to(device=like.device, dtype=like.dtype)


class Trainer:
    def __init__(self, *, step_fn: Callable, state: TrainState, pipeline,
                 ckpt: Optional[CheckpointManager] = None,
                 checkpoint_every: int = 200,
                 log_every: int = 10,
                 watchdog: Optional[StragglerWatchdog] = None,
                 metrics_hook: Optional[Callable[[int, Dict], None]] = None):
        self.step_fn = step_fn
        self.state = state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.log_every = log_every
        self.watchdog = watchdog or StragglerWatchdog()
        self.metrics_hook = metrics_hook
        self.history: list = []
        self.device = tree_lib.leaves(state.params)[0].device

    def maybe_restore(self) -> int:
        """Resume from the latest checkpoint if one exists."""
        if self.ckpt is None:
            return 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        self.state = self.ckpt.restore(latest, self.state, placer=_place)
        return latest

    def run(self, num_steps: int) -> Dict[str, float]:
        last_loss = float("nan")
        for _ in range(num_steps):
            step_idx, batch = next(self.pipeline)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            t0 = time.time()
            self.state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])          # sync point
            dt = time.time() - t0
            slow = self.watchdog.record(step_idx, dt)
            rec = {"step": step_idx, "loss": loss, "dt": dt, "slow": slow,
                   "grad_norm": float(metrics["grad_norm"])}
            self.history.append(rec)
            last_loss = loss
            if self.metrics_hook and step_idx % self.log_every == 0:
                self.metrics_hook(step_idx, rec)
            if (self.ckpt is not None and self.checkpoint_every
                    and (step_idx + 1) % self.checkpoint_every == 0):
                self.ckpt.save(step_idx + 1, self.state)
        if self.ckpt is not None:
            self.ckpt.wait()
        losses = [h["loss"] for h in self.history]
        return {
            "final_loss": last_loss,
            "min_loss": min(losses) if losses else float("nan"),
            "mean_dt": float(np.mean([h["dt"] for h in self.history])),
            "straggler_steps": len(self.watchdog.slow_steps),
        }
