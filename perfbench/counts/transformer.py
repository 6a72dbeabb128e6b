"""The counts of a decoder-only transformer with attention through B1 in
every layer and, where it has experts, a routed MoE in every layer: the
counts of a configuration that names no ``counts`` module.

A counts module exposes these three functions; a configuration of another
family names its own module under ``counts`` (a path under
``perfbench/``), and the readers take the counts through the window:

* ``step_flops(d, lanes, sampled_rows)``: a step's model FLOPs, as
  ``flops.py`` defines them;
* ``b1_step_bound_s(d, lanes, block_size)``: the least time of a step's
  B1 calls, over every layer that runs B1, as ``(seconds, "flops" |
  "bytes")``;
* ``moe_step_bound_s(d, tokens)``: the least time of a step's MoE layers,
  likewise.
"""
from perfbench.counts import b1, flops, moe

step_flops = flops.step_flops
b1_step_bound_s = b1.step_bound_s
moe_step_bound_s = moe.step_bound_s
