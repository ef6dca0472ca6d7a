"""Deterministic synthetic token pipeline, host-sharded.

The port's own copy of ``repro.data.pipeline`` (pure NumPy, verbatim
below this paragraph): its batches are bitwise equal to the JAX
package's. The train step moves them to the model's device.

Generates language-model batches on the host with a counter-based PRNG, so:

* every (step, host) pair maps to a unique, reproducible batch slice —
  restart at step k regenerates exactly the batch stream from step k
  (checkpoint/restart determinism, DESIGN.md §6);
* each host materializes only its slice of the global batch
  (``host_index/host_count``), the way a multi-host pod feeds data;
* a background prefetch thread keeps ``prefetch`` batches ready.

Synthetic text = Zipf-distributed tokens with short-range structure
(repeat-previous with prob 0.2) — enough signal that training loss visibly
drops in the examples.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 host_index: int = 0, host_count: int = 1, seed: int = 1234):
        assert global_batch % host_count == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // host_count
        self.host_index = host_index
        self.host_count = host_count
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_index]))
        B, S = self.local_batch, self.seq_len
        zipf = rng.zipf(1.3, size=(B, S + 1))
        toks = np.minimum(zipf, self.vocab - 1).astype(np.int32)
        rep = rng.random((B, S + 1)) < 0.2
        for t in range(1, S + 1):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        return {"tokens": toks[:, :S], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a step-indexed source."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, prefetch: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            batch = self.source.batch_at(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self.q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> Dict[str, np.ndarray]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
