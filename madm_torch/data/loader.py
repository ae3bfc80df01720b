"""Data loaders: infinite train iterator + test iterator with prefetch (port of
``madm_tpu/data/loader.py``).

Replaces the reference's detectron2 dataloader builders (``data/build.py``):

- train (``build_d2_train_dataloader``, ``:64-100``): infinite stream with a
  seeded shuffle (``np.random.default_rng(seed)``, the JAX package's order).
- test (``build_d2_test_dataloader``, ``:103-141``): the test set in order
  (InferenceSampler semantics).

The builders take this rank's shard of ``torch.distributed`` (shard 0 of 1
without a process group), as JAX's ``_process_shard`` takes the process's:
train rank r reads positions r, r+R, ... of one permutation drawn from the
same seed on every rank; test rank r a contiguous block.  A background thread
decodes/augments the next batches while the card computes (the reference
uses torch DataLoader worker processes).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel import dist as dist_lib


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
            # the ablations' extra images: two-stage pl data, FDA remove_amp,
            # remove_texture
            for key in ("source_pl_data", "source_rgb_pha", "target_second_modality_pha"):
                if key in samples[0]:
                    batch[key] = _stack(samples, key) / 255.0
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
        self.shard_index, self.num_shards = shard_index, num_shards
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


def _process_shard():
    """(shard_index, num_shards) = (rank, world size) of the process group
    (the reference's per-rank split, ``data/build.py:77-100``); (0, 1)
    without one."""
    return dist_lib.rank(), dist_lib.world()


def build_d2_train_dataloader(dataset, total_batch_size: int, num_workers: int = 0,
                              seed: int = 0, **kwargs) -> TrainLoader:
    """Config-compatible builder (reference ``data/build.py:64``): this
    rank's share of each global batch."""
    shard, num = _process_shard()
    return TrainLoader(dataset, total_batch_size, shard_index=shard, num_shards=num, seed=seed)


def build_d2_test_dataloader(dataset, local_batch_size: int = 1, num_workers: int = 0,
                             **kwargs) -> TestLoader:
    """Config-compatible builder (reference ``data/build.py:103``): this
    rank's contiguous shard of the test set (InferenceSampler semantics,
    ``data/build.py:135-141``); the evaluator sums the confusion matrices
    over the ranks."""
    assert local_batch_size == 1, "test batch size is 1 per rank (ref data/build.py:129)"
    shard, num = _process_shard()
    return TestLoader(dataset, shard_index=shard, num_shards=num)
