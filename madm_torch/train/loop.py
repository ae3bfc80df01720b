"""Trainer entry point: build the state, take N UDA steps, return the
per-step metrics.  The state lives on the card unless the caller passes
``device="cpu"``; nothing moves to the CPU by itself.

    state = init_train_state(MADMConfig(), TrainConfig())
    history = train(state, batches, steps=3, generator=torch.Generator("cuda"))

``synthetic_batches`` makes seeded stand-in batches (images uniform in
[0, 1], labels of a few class blobs with some ignored pixels) for running
without a dataset, with the extra images an ablation reads on request.

Under a process group (``madm_torch.parallel``), every
rank builds the same state from the same seed, ``train`` takes global
batches and steps each rank on its rows, and the generator must be seeded
alike on every rank (``sample_draws`` draws for the global batch).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

import torch

from ..device import resolve_device
from ..models.madm import MADM, MADMConfig, init_random_
from ..parallel import dist as dist_lib
from .train_step import (
    TrainConfig,
    TrainState,
    add_feature_distance_baseline,
    make_train_state,
    train_step,
)

BLOBS = 6  # class discs per synthetic label map


def synthetic_batches(batch_size: int, crop: Tuple[int, int], num_classes: int,
                      generator: torch.Generator,
                      extra: Sequence[str] = ()) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless seeded batches on the generator's device: 'source_rgb' and
    'target_second_modality' uniform in [0, 1]; 'source_label' a random
    background class with ``BLOBS`` discs of random classes and one
    rectangle of ignored (255) pixels per image; and each key of ``extra``
    ('source_pl_data', 'target_second_modality_pha') uniform in [0, 1]."""
    dev = generator.device
    h, w = crop
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=dev)

    while True:
        labels = []
        for _ in range(batch_size):
            lbl = torch.full((h, w), int(rand(()) * num_classes), dtype=torch.int64, device=dev)
            for cy, cx, r, c in rand(BLOBS, 4).tolist():
                disc = (ys - cy * h) ** 2 + (xs - cx * w) ** 2 < (0.1 + 0.25 * r) ** 2 * h * w
                lbl[disc] = int(c * num_classes)
            y0, x0 = int(rand(()) * h * 0.8), int(rand(()) * w * 0.8)
            lbl[y0:y0 + h // 10, x0:x0 + w // 10] = 255
            labels.append(lbl)
        batch = {"source_rgb": rand(batch_size, h, w, 3), "source_label": torch.stack(labels),
                 "target_second_modality": rand(batch_size, h, w, 3)}
        batch.update({k: rand(batch_size, h, w, 3) for k in extra})
        yield batch


def init_train_state(model_cfg: MADMConfig, train_cfg: TrainConfig, device: str = "cuda",
                     seed: int = 0) -> TrainState:
    """A trainable model on seeded random weights (no checkpoint is in the
    repository) with its optimizer, and the fd baseline when ``train_cfg.fd``."""
    dev = resolve_device(device)
    model = init_random_(MADM(model_cfg, device=dev, trainable=True),
                         torch.Generator(device=dev).manual_seed(seed))
    state = make_train_state(model, train_cfg)
    return add_feature_distance_baseline(state) if train_cfg.fd else state


def train(state: TrainState, batches: Iterable[Dict[str, torch.Tensor]], steps: int,
          generator: torch.Generator) -> List[Dict[str, float]]:
    """Take ``steps`` UDA steps on ``state`` (in place) with batches from
    ``batches`` and random draws from ``generator``; returns the per-step
    metrics.  Each step's metrics gain ``step_ms``, host time to the step's
    end (its metrics are read from the device).  Under a process group of
    any size, each batch is the global one and this rank steps on its
    rows (``local_rows``)."""
    it = iter(batches)
    history = []
    for _ in range(steps):
        batch = next(it)
        if dist_lib.initialized():
            rows = dist_lib.local_rows(next(iter(batch.values())).shape[0])
            batch = {k: v[rows] for k, v in batch.items()}
        t0 = time.perf_counter()
        metrics = train_step(state, batch, generator)
        metrics["step_ms"] = (time.perf_counter() - t0) * 1e3
        history.append(metrics)
    return history
