"""Deterministic synthetic batches and a prefetching pipeline (port of
``repro.data.pipeline``).

A dataset yields numpy batches from ``(seed, step, host)`` alone, through a
Philox generator keyed on the seed with counter ``[step, host, 0, 0]``, so
its batches are byte-identical to the reference's, and resuming at step k
reproduces the stream with no state file.  Host ``i`` of ``n`` draws only
its slice of the global batch.  :class:`DataPipeline` makes the batches in
a bounded background thread; the trainer moves each to the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLMDataset:
    """Deterministic token batches: batch (B, S) int32."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int, host: int = 0, num_hosts: int = 1
                 ) -> Dict[str, np.ndarray]:
        b = self.global_batch // num_hosts
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, host, 0, 0]))
        tokens = rng.integers(0, self.vocab_size, (b, self.seq_len),
                              dtype=np.int32)
        return {"tokens": tokens}


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


class DataPipeline:
    """Bounded background prefetcher over a deterministic dataset."""

    def __init__(self, dataset, start_step: int = 0, prefetch: int = 2,
                 host: int = 0, num_hosts: int = 1):
        self.dataset = dataset
        self.host = host
        self.num_hosts = num_hosts
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step, self.host, self.num_hosts)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
