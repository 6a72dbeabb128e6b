"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything that belongs to one configuration, traffic mix
or metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the model's sizes, the serving knobs, the KV
  pool and the limits that decide ``correct``; optionally the ``model``
  module that builds it and the ``counts`` module of its arithmetic, each
  a path under ``perfbench/`` (without them ``harness/model.py``, the
  port's ``TransformerLM``, and ``counts/transformer.py``);
* ``traffic/<mix>.json``: a mix's parameters, read by the generator named
  by its ``kind`` (``traffic/<kind>.py``);
* ``metrics/<metric>.py``: one reader per metric, ``read(window)``;
* ``systems/<system>.py``: what drives the program for a configuration's
  ``system``;
* ``counts/``: the frozen FLOP and byte formulas and the card's peaks;
* ``reference/``: the plain float32 PyTorch reference.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
imports nothing of ``repro_torch`` either.
"""
