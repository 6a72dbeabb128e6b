"""Activation sharding at layer boundaries (port of
``repro.distributed.act_sharding``).

The reference re-anchors the batch dim of every block's input to the data
axes with ``with_sharding_constraint``, because GSPMD loses that sharding
inside remat'd scan bodies; :func:`activation_sharding` scopes the axes so
model code stays mesh-agnostic, and ``moe_apply`` reads them
(:func:`current_data_axes`).

Under explicit ranks there is nothing to re-anchor: each rank runs its
step on its own batch shard (``jit_train_step`` cuts it by
``ShardingRules.batch_spec``), so the batch a model sees is already the
shard and :func:`constrain_batch` is the identity.  The reference's
divisibility rule (a batch the axes do not divide stays unsharded) is
``batch_spec``'s, applied where the batch is cut.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

_ACT_AXES: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "repro_torch_act_axes", default=None)


@contextlib.contextmanager
def activation_sharding(dp_axes: Sequence[str]):
    """Scope under which activations are batch-sharded over ``dp_axes``."""
    tok = _ACT_AXES.set(tuple(dp_axes))
    try:
        yield
    finally:
        _ACT_AXES.reset(tok)


def constrain_batch(x):
    """``x`` itself: under explicit ranks dim0 is this rank's batch shard
    already (module docstring)."""
    return x


def current_data_axes():
    """The data axes scoped by :func:`activation_sharding` (or None)."""
    return _ACT_AXES.get()
