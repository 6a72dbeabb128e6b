"""Train step (port of ``repro.training.train_step``): loss, gradients,
optimizer update, on one device.

A step computes the loss, ``torch.autograd.grad`` over the parameters'
floating-point leaves, ``lr_fn(step)``, ``optimizer.update`` and
``apply_updates``, and returns the metrics ``{"loss", "grad_norm",
"lr"}`` as 0-d tensors (nothing is read on the host).  One step function
serves every model with a ``loss(params, batch)``.

On a mesh (:func:`jit_train_step`, the reference's pjit step) each rank
runs an eager step on its own shards: :func:`state_specs` gives the
reference's specs (the moments their parameter's, the step counter
replicated), the step cuts the rank's slice of the global batch by
``rules.batch_spec``, the model's sharded loss is the global mean and its
gradients come back through the collectives' conjugates, and AdamW
updates each shard with the global norm of the sharded tree.  No name
here builds a compiled program: ``jit_train_step`` keeps the reference's
name for an eager step of one rank.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.optim.optimizer import Optimizer, apply_updates


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def init_state(model, seed: int, optimizer: Optimizer,
               shard: Optional[Callable] = None) -> TrainState:
    """Parameters from ``model.init(seed)``, the optimizer's state and a
    step counter of 0, on the model's device.  ``shard`` (a model's
    ``shard_fn(mesh)``): this rank's shards only, each leaf cut as it is
    drawn, so the whole tree is never held."""
    params = model.init(seed) if shard is None else model.init(seed,
                                                               shard=shard)
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


def abstract_state(model, optimizer: Optimizer) -> TrainState:
    """:func:`init_state`'s tree as meta tensors (shapes and dtypes, drawn
    from nothing and allocated nowhere): the dry-run input."""
    params = model.init_abstract()
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device="meta"))


def state_specs(rules, state_shape: TrainState) -> TrainState:
    """The specs of a state (:func:`abstract_state`'s): the params' from
    ``rules``, each moment its parameter's, step counters replicated."""
    p_spec = rules.params_tree(state_shape.params)
    opt = state_shape.opt
    return TrainState(params=p_spec, opt=type(opt)(**{
        f: () if f == "step" else p_spec for f in opt._fields}), step=())


def jit_train_step(model, optimizer: Optimizer, lr_fn, mesh, rules,
                   state_shape: TrainState, batch_shape, donate: bool = True):
    """The reference's sharded train step, as an eager step of THIS rank:
    ``step(state, batch) -> (state, metrics)``, ``state`` this rank's
    shards (``init_state(..., shard=model.shard_fn(mesh))``) and ``batch``
    the global batch (``batch_shape``: its arrays' shapes), of which the
    step keeps the rank's slice by ``rules.batch_spec``.  The metrics are
    the global loss and gradient norm on every rank.  ``rules`` must give
    the model's own specs (``model.sharding_rules(mesh)``; checked here).

    ``donate``: the state is updated in place, as :func:`make_train_step`
    updates it (the reference donates its buffers); ``donate=False``
    copies it first, so the state passed in stays valid.  A one-rank mesh
    runs the one-device step."""
    from repro_torch.distributed.sharding import shard_leaf, spec_leaves

    specs = state_specs(rules, state_shape)
    on_mesh = mesh.devices > 1
    if on_mesh and specs.params != model.sharding_rules(mesh).params_tree(
            state_shape.params):
        raise ValueError("jit_train_step: rules give other specs than the "
                         "model's own sharding_rules(mesh)")
    b_spec = {k: rules.batch_spec(tuple(v.shape))
              for k, v in batch_shape.items()}
    split_axes = [tuple(a for e in sp if e is not None
                        for a in ((e,) if isinstance(e, str) else e))
                  for sp in spec_leaves(specs.params)]
    loss_fn = (functools.partial(model.loss, mesh=mesh) if on_mesh
               else model.loss)
    shard_kw = dict(mesh=mesh, split_axes=split_axes) if on_mesh else {}

    def step(state: TrainState, batch) -> tuple:
        if not donate:
            state = tree_lib.map(torch.clone, state)
        batch = {k: shard_leaf(v, b_spec[k], mesh) for k, v in batch.items()}
        loss, grads = loss_and_grads(loss_fn, state.params, batch)
        lr = lr_fn(state.step)
        updates, opt_state, gnorm = optimizer.update(
            grads, state.opt, state.params, lr, **shard_kw)
        params = apply_updates(state.params, updates)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step
