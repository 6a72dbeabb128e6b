"""Parameters of the JAX model -> the port's parameters, through numpy.

The caller turns the JAX pytree into nested dicts, lists and tuples of
numpy arrays (for example ``jax.tree.map(np.asarray, params)``); this
module imports no JAX.  Integer arrays keep their dtype (int32 stays
int32).
bfloat16 arrays pass through float32, since torch cannot read numpy's
bfloat16 extension type, and come back to bfloat16 on the device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import device as device_lib


def _to_torch(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts, lists and tuples of numpy arrays -> the same tree of
    torch tensors."""
    dev = device_lib.resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _to_torch(node, dev)

    return conv(tree)
