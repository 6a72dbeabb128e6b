"""Layer-stacked parameter trees, shared by the port's models.

The reference stacks a model's per-layer parameters on a leading axis
(``jax.vmap(_layer_init)``; zamba2's mamba layers on two, groups then
layers).  The port keeps those trees, so that ``models.bridge`` carries
JAX parameters across and checkpoints keep one leaf order, and walks the
layers in a Python loop.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from repro_torch import tree as tree_lib

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, device: torch.device) -> Optional[torch.Generator]:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on the
    meta device, which has no generator and draws nothing."""
    if device.type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def on_meta(model):
    """A copy of ``model`` whose device is ``meta``: what it makes has the
    shapes and dtypes of the real thing, and nothing is drawn or
    allocated."""
    meta = copy.copy(model)
    meta.device = torch.device("meta")
    return meta


def init_abstract(model):
    """The tree ``model.init()`` returns, with the same keys, shapes and
    dtypes, as meta tensors (``init`` of :func:`on_meta`)."""
    return on_meta(model).init()


def init_stacked(n: int, make):
    """``n`` calls of ``make()`` (a dict of tensors each), stacked on a
    leading axis as ``torch.stack`` would stack them.  Each layer is
    written into the preallocated stack as soon as it is made, so the
    peak is the stack and one layer (a list of the layers and then
    ``torch.stack`` would hold every leaf twice: 80 GB for
    internvl2-26b's 40 GB of layers)."""
    first = make()
    out = tree_lib.map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    dst = tree_lib.leaves(out)
    for i in range(n):
        lay = first if i == 0 else make()
        for d, s in zip(dst, tree_lib.leaves(lay)):
            d[i].copy_(s)
        del lay
    return out


def unstack(tree, n: int):
    """An ``L``-stacked parameter dict -> ``n`` per-layer dicts, each leaf
    split once with ``unbind``: its gradient is one stack of the layers'
    gradients, where a view per layer would add each layer's gradient
    into a zeroed copy of the whole stacked leaf (L times its bytes)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return tree.unbind(0)


def layer(tree, i: int):
    """Layer ``i`` of an ``L``-stacked parameter dict (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
