"""Train step (port of ``repro.training.train_step``): loss, gradients,
optimizer update, on one device.

A step computes the loss, ``torch.autograd.grad`` over the parameters'
floating-point leaves, ``lr_fn(step)``, ``optimizer.update`` and
``apply_updates``, and returns the metrics ``{"loss", "grad_norm",
"lr"}`` as 0-d tensors (nothing is read on the host).  One step function
serves every model with a ``loss(params, batch)``.  The reference's
``abstract_state``, ``state_specs`` and ``jit_train_step`` shard the step
over a mesh (GSPMD); they wait for multi-GPU (ROADMAP A10, A13).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.optim.optimizer import Optimizer, apply_updates


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def init_state(model, seed: int, optimizer: Optimizer) -> TrainState:
    """Parameters from ``model.init(seed)``, the optimizer's state and a
    step counter of 0, on the model's device."""
    params = model.init(seed)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def loss_and_grads(loss_fn: Callable, params, batch):
    """(loss, grads): the gradient of ``loss_fn(params, batch)`` with
    respect to every floating-point leaf of ``params``; a leaf that is not
    floating point (DLRM's ``table_offsets``) gets float32 zeros, so the
    tree keeps the reference's shape."""
    flat, structure = tree_lib.flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) if p.is_floating_point()
              else p for p in flat]
        loss = loss_fn(tree_lib.unflatten(structure, xs), batch)
        wrt = [x for x in xs if x.is_floating_point()]
        found = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                         materialize_grads=True))
    grads = [next(found) if p.is_floating_point() else
             torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in flat]
    return loss.detach(), tree_lib.unflatten(structure, grads)


def make_train_step(model, optimizer: Optimizer,
                    lr_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Returns step(state, batch) -> (state, metrics).  The parameters and
    the optimizer's moments are updated in place (``optim.optimizer``)."""

    def step(state: TrainState, batch) -> tuple:
        loss, grads = loss_and_grads(model.loss, state.params, batch)
        lr = lr_fn(state.step)
        updates, opt_state, gnorm = optimizer.update(
            grads, state.opt, state.params, lr)
        params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step
