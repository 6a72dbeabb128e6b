"""Shared benchmark utilities of the port: timing, row printing and the
H100 roofline time model (port of ``benchmarks/common.py``; its
``tpu_time_model`` becomes :func:`roofline_ms` over
``repro_torch.roofline.analysis.HW``).

On the card a call is timed with CUDA events after warm-up; on the CPU,
where the caller asked for it, with the host clock.  Every row names the
device it ran on, so a CPU time never reads as a device time, and rates
measured against the card's peaks are printed only for card rows.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.roofline.analysis import H100, time_model

WARMUP, REPS = 2, 5
CALLS = WARMUP + REPS        # calls of fn per time_ms


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


def device_ms(fn: Callable, *args, device,
              reps: int = 4 * REPS) -> Optional[float]:
    """Card only: milliseconds per call of ``fn(*args)`` over ``reps``
    back-to-back calls between two CUDA events, after ``WARMUP`` untimed
    ones, so that the device's queue stays full where the host enqueues
    faster than the device runs.  None (not measured) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    for _ in range(WARMUP):
        fn(*args)
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def kernel_ms(op, *args, device, reps: int = 4 * REPS,
              **kw) -> Optional[float]:
    """Card only: device milliseconds per launch of the kernel behind the
    wrapper ``op`` on ``op.prepare(*args, **kw)``, launched back to back
    through its C entry point (the wrapper's checks and allocations run
    once, and these launches do not count in ``op.launches``).  None on
    the CPU."""
    if torch.device(device).type != "cuda":
        return None
    launch = op.prepare(*args, **kw)

    def go():
        err = launch.fn(*launch.argv)
        if err != 0:
            raise RuntimeError(f"{op.name} kernel launch failed: {err}")

    return device_ms(go, device=device, reps=reps)


def device_name(device: torch.device) -> str:
    """What a row names as its device: the card's name, or ``cpu``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def emit(name: str, ms: float, derived: str) -> Dict[str, object]:
    """Print one row as ``name,ms,derived`` and return it as a dict."""
    print(f"{name},{ms:.4f},{derived}", flush=True)
    return {"name": name, "ms": ms, "derived": derived}


def roofline_ms(flops: float, nbytes: float, dtype: torch.dtype) -> float:
    """The H100 roofline's least milliseconds for ``flops`` operations on
    ``dtype`` and ``nbytes`` bytes moved (a prediction, not a timing)."""
    return 1e3 * time_model(flops, nbytes, dtype)


def rates(ms: Optional[float], flops: float, nbytes: float) -> str:
    """Rates of a card time ``ms`` beside the H100's peaks, as derived
    fields; nothing where the time was not measured (a CPU row)."""
    if ms is None:
        return ""
    return (f";gbs={nbytes / ms / 1e6:.1f}"
            f";hbm_share={nbytes / ms / 1e-3 / H100.hbm_bw:.4f}"
            f";tflops={flops / ms / 1e9:.2f}")
