"""LR schedules (port of ``repro.optim.schedules``): pure functions of the
step, a Python int or a 0-d tensor, returning a 0-d float32 tensor on the
step's device (the CPU for an int), so a step counter on the card is
never read on the host."""
from __future__ import annotations

import math

import torch


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def lr(step):
        # a Python step is computed in double, as the reference's float()
        step = step.float() if torch.is_tensor(step) else float(step)
        warm = base_lr * step / max(1, warmup_steps)
        progress = torch.clamp(torch.as_tensor(
            (step - warmup_steps) / max(1, total_steps - warmup_steps),
            dtype=torch.float32), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * progress)))
        warm = torch.as_tensor(warm, dtype=torch.float32,
                               device=cos.device)
        return torch.where(torch.as_tensor(step < warmup_steps,
                                           device=cos.device), warm, cos)
    return lr


def constant(base_lr: float):
    def lr(step):
        device = step.device if torch.is_tensor(step) else None
        return torch.full((), base_lr, dtype=torch.float32, device=device)
    return lr
