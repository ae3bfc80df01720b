"""Config utilities (a copy of ``madm_tpu/config/utils.py``; reference:
``config/utils.py:4-66`` linear-scaling rule)."""

from __future__ import annotations

import copy
import logging


def auto_scale_workers(cfg, num_workers: int):
    """Scale batch size / lr / schedule by the world-size ratio.

    Same arithmetic as the reference's linear-scaling rule
    (``config/utils.py:43-66``): the config declares
    ``cfg.train.reference_world_size``; launching on ``num_workers`` devices
    rescales total batch, lr, max_iter and the eval/checkpoint periods so the
    effective training run is equivalent.
    """
    old_world_size = cfg.train.get("reference_world_size", 0)
    if old_world_size == 0 or old_world_size == num_workers:
        return cfg
    cfg = copy.deepcopy(cfg)
    batch = cfg.dataloader.train.total_batch_size
    if batch % old_world_size != 0:
        raise ValueError(
            f"total_batch_size {batch} is not divisible by "
            f"reference_world_size {old_world_size}; cannot linear-scale"
        )
    scale = num_workers / old_world_size
    bs = cfg.dataloader.train.total_batch_size = int(round(batch * scale))
    lr = cfg.optimizer.lr = cfg.optimizer.lr * scale
    max_iter = cfg.train.max_iter = int(round(cfg.train.max_iter / scale))
    cfg.train.eval_period = int(round(cfg.train.eval_period / scale))
    cfg.train.checkpointer.period = int(round(cfg.train.checkpointer.period / scale))
    cfg.train.reference_world_size = num_workers
    logging.getLogger(__name__).info(
        "linear-scaled config for %d workers: batch %d, lr %g, max_iter %d",
        num_workers, bs, lr, max_iter,
    )
    return cfg
