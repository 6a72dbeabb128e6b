"""Shared benchmark utilities of the port: timing and row printing (the
port's half of ``benchmarks/common.py``, without the TPU roofline).

On the card a call is timed with CUDA events after warm-up; on the CPU,
where the caller asked for it, with the host clock.  Every row names the
device it ran on, so a CPU time never reads as a device time.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

import torch

WARMUP, REPS = 2, 5


def time_ms(fn: Callable, *args, device: torch.device,
            warmup: int = WARMUP, reps: int = REPS) -> float:
    """Median milliseconds per call of ``fn(*args)`` over ``reps`` timed
    calls after ``warmup`` untimed ones (``warmup + reps`` calls in all).

    CUDA: each call between two CUDA events, read after a synchronise.
    CPU: the host clock around each call.
    """
    for _ in range(warmup):
        fn(*args)
    times: List[float] = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for start, end in events:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize(device)
        times = [s.elapsed_time(e) for s, e in events]
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def device_name(device: torch.device) -> str:
    """What a row names as its device: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def emit(name: str, ms: float, derived: str) -> Dict[str, object]:
    """Print one row as ``name,ms,derived`` and return it as a dict."""
    print(f"{name},{ms:.4f},{derived}", flush=True)
    return {"name": name, "ms": ms, "derived": derived}
