"""Device choice for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
card that default raises: the port never falls back to the CPU on its own.
The CPU is used only when the caller asks for it, as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raise if it names an absent card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev
