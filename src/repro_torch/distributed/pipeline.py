"""GPipe-style pipeline parallelism over a mesh axis of ranks (port of
``repro.distributed.pipeline``).

* stage s owns layers [s·L/S, (s+1)·L/S) (``stage_params``: this rank's);
* the loop runs S + M - 1 ticks (M microbatches): at tick t stage 0 takes
  microbatch t, every other stage the activation the stage before it
  shifted to it at the end of tick t - 1, and each stage shifts its output
  to the next (``collectives.shift``, point to point);
* a stage holds a real microbatch (t - s in [0, M)) only on M of the
  ticks; on the others (the warm-up and drain bubbles) it computes
  nothing and shifts zeros, where the reference computes a value it never
  stores: the stored outputs are the same;
* bubble fraction = (S - 1) / (S + M - 1), :func:`bubble_fraction`.

Forward only, as the reference's.  The last stage's outputs reach every
rank as a SUM over the axis of the outputs, each rank but the last
contributing zeros (the reference's replicated result).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.distributed import collectives


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_stages + num_microbatches - 1)


def pipeline_forward(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x_micro: torch.Tensor, *, mesh,
                     axis: str, num_stages: int) -> torch.Tensor:
    """Run the microbatched pipeline forward of THIS rank's stage.

    ``layer_fn(stage_params, x)`` applies this stage's layers (its output
    the shape of its input); ``x_micro`` (M, mb, ...) the microbatches,
    held by every rank (stage 0 feeds them; later stages receive by
    shift).  Returns (M, mb, ...) the last stage's outputs on every rank.
    """
    stage = mesh.axis_index(axis)
    S = num_stages
    if mesh.size(axis) != S:
        raise ValueError(f"{S} stages on an axis of {mesh.size(axis)} ranks")
    M = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])        # the activation in flight here
    outs = torch.zeros_like(x_micro)
    for t in range(S + M - 1):
        mid = t - stage                       # this tick's microbatch here
        if 0 <= mid < M:
            y = layer_fn(stage_params, x_micro[t] if stage == 0 else buf)
            if stage == S - 1:
                outs[mid] = y
        else:
            y = torch.zeros_like(buf)
        buf = collectives.shift(y, mesh, axis)
    if stage != S - 1:
        outs.zero_()
    return collectives.all_reduce(outs, mesh, axis)
