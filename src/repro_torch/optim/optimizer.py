"""Optimizers (port of ``repro.optim.optimizer``): AdamW and SGD-momentum.

The reference's functional API: ``opt.init(params) -> state`` and
``opt.update(grads, state, params, lr) -> (updates, state, grad_norm)``,
then ``apply_updates(params, updates)``.  Trees are the reference's
(:mod:`repro_torch.tree`): the state holds an ``m`` and a ``v`` (or a
``mom``) for every leaf.  Moments are float32 whatever the parameter's
dtype; updates are cast back to it.  Global-norm clipping is built in.

What differs, on purpose:

* the moments are updated in place and handed back in the new state, and
  :func:`apply_updates` adds the updates into the parameters in place:
  the same values, without a second copy of a 5 GB table.  A state or a
  parameter tree passed in must not be read again as it was;
* a leaf that is not floating point (DLRM's int32 ``table_offsets``) gets
  a zero update and keeps its moments, where the reference raises.

``lr`` is a Python float or a 0-d tensor (``schedules``), so nothing here
reads the card on the host.

On a mesh (``update(..., mesh=, split_axes=)``, the sharded train step)
the trees hold this rank's shards and ``split_axes`` names, leaf by leaf,
the mesh axes that split it: the global norm sums each leaf's squares over
exactly those axes (:func:`global_norm`), so a leaf replicated over an
axis is counted once, and clipping scales every shard by the same factor.
The elementwise AdamW update needs nothing else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_lib


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _f32_zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def global_norm(tree, mesh=None, split_axes=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (0-d tensor).

    ``mesh``, ``split_axes`` (one tuple of axis names per leaf, in the
    tree's order): ``tree`` holds this rank's shards; the squares of the
    leaves split by the same axes are summed here and then over those axes
    (one SUM an axis and a set of axes), and the sets added in a fixed
    order, so every rank gets the same norm of the whole tree."""
    sums: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
    flat = tree_lib.leaves(tree)
    axes_of = split_axes if mesh is not None else [()] * len(flat)
    for x, axes in zip(flat, axes_of):
        v = x.detach().reshape(-1).float()
        sums.setdefault(tuple(axes), []).append(torch.dot(v, v))
    total = []
    for axes in sorted(sums):
        part = torch.stack(sums[axes]).sum()
        if axes:
            from repro_torch.distributed import collectives
            for a in axes:
                collectives.all_reduce(part, mesh, a)
        total.append(part)
    return torch.sqrt(torch.stack(total).sum())


def clip_by_global_norm(tree, max_norm: float, mesh=None, split_axes=None):
    """(every leaf in float32 times min(1, max_norm / norm), norm); the
    norm over a sharded tree with ``mesh`` and ``split_axes``."""
    norm = global_norm(tree, mesh, split_axes)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_lib.map(lambda g: g.float() * scale, tree), norm


def _clip_or_widen(grads, grad_clip: Optional[float], mesh, split_axes):
    if grad_clip is not None:
        return clip_by_global_norm(grads, grad_clip, mesh, split_axes)
    grads = tree_lib.map(lambda g: g.float(), grads)
    return grads, global_norm(grads, mesh, split_axes)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, grad_clip: Optional[float] = 1.0
          ) -> Optimizer:
    def init(params):
        step = torch.zeros((), dtype=torch.int32,
                           device=_device(params))
        return AdamWState(step=step, m=tree_lib.map(_f32_zeros, params),
                          v=tree_lib.map(_f32_zeros, params))

    def update(grads, state: AdamWState, params, lr, *, mesh=None,
               split_axes=None):
        grads, gnorm = _clip_or_widen(grads, grad_clip, mesh, split_axes)
        step = state.step + 1
        bc1 = 1.0 - torch.pow(b1, step.float())
        bc2 = 1.0 - torch.pow(b2, step.float())
        flat_p, structure = tree_lib.flatten(params)
        updates = []
        for p, g, m, v in zip(flat_p, tree_lib.leaves(grads),
                              tree_lib.leaves(state.m),
                              tree_lib.leaves(state.v)):
            if not p.is_floating_point():
                updates.append(torch.zeros_like(p))
                continue
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                u.add_(p.detach().float(), alpha=weight_decay)
            updates.append(u.mul_(-lr).to(p.dtype))
        return (tree_lib.unflatten(structure, updates),
                AdamWState(step, state.m, state.v), gnorm)

    return Optimizer(init=init, update=update)


class SGDState(NamedTuple):
    step: torch.Tensor
    mom: Any


def sgd_momentum(momentum: float = 0.9, grad_clip: Optional[float] = None
                 ) -> Optimizer:
    def init(params):
        return SGDState(step=torch.zeros((), dtype=torch.int32,
                                         device=_device(params)),
                        mom=tree_lib.map(_f32_zeros, params))

    def update(grads, state: SGDState, params, lr, *, mesh=None,
               split_axes=None):
        grads, gnorm = _clip_or_widen(grads, grad_clip, mesh, split_axes)
        flat_p, structure = tree_lib.flatten(params)
        updates = []
        for p, g, b in zip(flat_p, tree_lib.leaves(grads),
                           tree_lib.leaves(state.mom)):
            if not p.is_floating_point():
                updates.append(torch.zeros_like(p))
                continue
            b.mul_(momentum).add_(g)
            updates.append((b * -lr).to(p.dtype))
        return (tree_lib.unflatten(structure, updates),
                SGDState(state.step + 1, state.mom), gnorm)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates`` in each leaf's dtype, added in place; returns
    ``params``."""
    for p, u in zip(tree_lib.leaves(params), tree_lib.leaves(updates)):
        if p.is_floating_point():
            p.add_(u.to(p.dtype))
    return params


def _device(params) -> torch.device:
    """The device of the first leaf (where the step counter lives)."""
    first = tree_lib.leaves(params)
    return first[0].device if first else torch.device("cpu")
