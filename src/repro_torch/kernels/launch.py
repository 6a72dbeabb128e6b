"""What every kernel wrapper of the port shares: a prepared launch, and the
wrapper base class that chooses by the device of its first tensor.

For a CUDA tensor a wrapper checks its inputs, allocates its output and
scratch with ``torch.empty``, launches on the current stream and adds one
to :attr:`KernelOp.launches`; for a CPU tensor it runs its plain PyTorch
version.  Nothing falls back.  ``prepare`` returns the C entry point and
its arguments, so ``chip_smoke.py`` can time back-to-back launches without
the wrapper's host work.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class Launch(NamedTuple):
    """One prepared kernel launch: ``fn(*argv)`` returns the CUDA error
    code (0 = ok) and writes ``out``; ``scratch`` must outlive the call.
    ``fn`` is None where there is nothing to compute (an empty input):
    then nothing is launched and ``out`` is already the result."""
    fn: Optional[Callable[..., int]]
    argv: Tuple
    out: torch.Tensor
    scratch: Optional[torch.Tensor]


class KernelOp:
    """A kernel wrapper chosen by the device of its first argument: CUDA
    runs :meth:`prepare` and launches; CPU runs :meth:`plain`.  Subclasses
    give both."""

    name = ""

    def __init__(self):
        self.launches = 0           # kernel launches, a plain integer

    def plain(self, *args, **kw):
        raise NotImplementedError

    def prepare(self, *args, **kw) -> Launch:
        raise NotImplementedError

    def __call__(self, x, *args, **kw):
        if x.device.type != "cuda":
            return self.plain(x, *args, **kw)
        launch = self.prepare(x, *args, **kw)
        if launch.fn is None:
            return launch.out
        err = launch.fn(*launch.argv)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err}")
        self.launches += 1
        return launch.out
