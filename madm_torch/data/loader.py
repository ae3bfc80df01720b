"""Data loaders: infinite train iterator + test iterator with prefetch (port of
``madm_tpu/data/loader.py``).

Replaces the reference's detectron2 dataloader builders (``data/build.py``):

- train (``build_d2_train_dataloader``, ``:64-100``): infinite stream with a
  seeded shuffle (``np.random.default_rng(seed)``, the JAX package's order).
- test (``build_d2_test_dataloader``, ``:103-141``): the test set in order
  (InferenceSampler semantics).

The port runs as one process, so the builders take the whole set
(shard 0 of 1); the classes keep the shard arguments.  A background thread
decodes/augments the next batches while the card computes (the reference
uses torch DataLoader worker processes).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def _stack(samples, key):
    return np.stack([s[key] for s in samples])


class TrainLoader:
    """Infinite iterator of stacked NHWC batches in [0, 1]."""

    def __init__(
        self,
        dataset,
        total_batch_size: int,
        shard_index: int = 0,
        num_shards: int = 1,
        seed: int = 0,
        prefetch: int = 2,
    ):
        assert total_batch_size % num_shards == 0, (
            f"total batch {total_batch_size} not divisible by {num_shards} shards"
        )
        self.dataset = dataset
        self.local_batch = total_batch_size // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.rng = np.random.default_rng(seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def _indices(self) -> Iterator[int]:
        n = len(self.dataset)
        while True:
            order = self.rng.permutation(n)
            # contiguous round-robin: rank r takes positions r, r+R, ...
            yield from order[self.shard_index :: self.num_shards]

    def _worker(self):
        it = self._indices()
        while True:
            samples = [self.dataset[int(next(it))] for _ in range(self.local_batch)]
            batch = {
                "source_rgb": _stack(samples, "source_rgb") / 255.0,
                "source_label": _stack(samples, "source_label").astype(np.int32),
                "target_second_modality": _stack(samples, "target_second_modality") / 255.0,
            }
            if "source_pl_data" in samples[0]:  # two-stage pl data
                batch["source_pl_data"] = _stack(samples, "source_pl_data") / 255.0
            self._q.put(batch)

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            yield self._q.get()


class TestLoader:
    """Iterates this rank's shard of the test set, one sample dict at a time.

    Images come out NHWC [1, H, W, 3] in [0, 1]; labels [H, W] int32.
    """

    def __init__(self, dataset, shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        n = len(dataset)
        per = (n + num_shards - 1) // num_shards
        self.start = min(shard_index * per, n)
        self.stop = min(self.start + per, n)

    def __len__(self):
        return self.stop - self.start

    def __iter__(self):
        for i in range(self.start, self.stop):
            s = self.dataset[i]
            out = dict(s)
            out["target_second_modality"] = (
                s["target_second_modality"][None] / 255.0
            ).astype(np.float32)
            yield out


def build_d2_train_dataloader(dataset, total_batch_size: int, num_workers: int = 0,
                              seed: int = 0, **kwargs) -> TrainLoader:
    """Config-compatible builder (reference ``data/build.py:64``); one process."""
    return TrainLoader(dataset, total_batch_size, seed=seed)


def build_d2_test_dataloader(dataset, local_batch_size: int = 1, num_workers: int = 0,
                             **kwargs) -> TestLoader:
    """Config-compatible builder (reference ``data/build.py:103``); one
    process evaluates the whole set."""
    assert local_batch_size == 1, "test batch size is 1 per rank (ref data/build.py:129)"
    return TestLoader(dataset)
