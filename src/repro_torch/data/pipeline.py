"""Deterministic synthetic batches (port of ``repro.data.pipeline``).

A dataset yields numpy batches from ``(seed, step, host)`` alone, through a
Philox generator keyed on the seed with counter ``[step, host, 0, 0]``, so
its batches are byte-identical to the reference's.  Host ``i`` of ``n``
draws only its slice of the global batch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticRecSysDataset:
    """Deterministic DLRM batches (dense features + per-table bag indices)."""

    def __init__(self, cfg, global_batch: int, seed: int = 0):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int, host: int = 0, num_hosts: int = 1
                 ) -> Dict[str, np.ndarray]:
        c = self.cfg
        b = self.global_batch // num_hosts
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, host, 0, 0]))
        return {
            "dense": rng.standard_normal((b, c.dense_features),
                                         dtype=np.float32),
            "indices": rng.integers(
                0, c.num_embeddings,
                (b, c.num_tables, c.gathers_per_table), dtype=np.int32),
            "label": rng.integers(0, 2, (b,), dtype=np.int32),
        }
