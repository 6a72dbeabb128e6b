"""Activation-checkpoint (remat) policies (port of
``repro.training.remat``).

``full`` recomputes the whole wrapped function in the backward
(``torch.utils.checkpoint.checkpoint``, non-reentrant); ``dots`` saves
the matrix products' outputs (``aten.mm``, ``aten.bmm``, ``aten.addmm``)
and recomputes the rest, the port's form of the reference's
``dots_with_no_batch_dims_saveable``; ``none`` is the function itself.
All three give the same loss and gradients.
"""
from __future__ import annotations

import functools
from typing import Callable, Union

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

Mode = Union[bool, str]

_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
          torch.ops.aten.addmm.default)


def resolve(mode: Mode) -> str:
    if mode is True:
        return "full"
    if mode is False:
        return "none"
    if mode not in ("full", "dots", "none"):
        raise ValueError(f"remat mode {mode!r}: expected full, dots or none")
    return mode


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def wrap(fn: Callable, mode: Mode) -> Callable:
    mode = resolve(mode)
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped
