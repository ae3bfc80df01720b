"""Checkpoint save/resume (port of ``madm_tpu/checkpoint/checkpointer.py``;
reference ``checkpoint/odise_checkpointer.py``).

A checkpoint is one ``.pth`` file written by ``torch.save``: ``{"format":
"madm_torch", "model": state_dict, "optimizer": the optimizer's state_dict
(AdamW's moments, or Adafactor's factored rows and columns and its
momentum, bf16 moments kept bf16), "step": int}``, and ``"consts"`` (the ``fd`` baseline's UNet and prompt state
dicts) when the state holds them, so that a resumed ``fd`` run keeps the
target it started with.  The model's ``state_dict`` has the reference key names and holds the
EMA teacher (``ema.*``) and the head's BN statistics (``running_mean`` /
``running_var`` of the student and the teacher); the frozen VAE is kept too,
so that a checkpoint restores a run without the SD snapshot it started from
(the JAX package leaves the VAE out and re-materialises it from the
snapshot).  Key behaviours as in the JAX package:

- ``resume_or_load(init_from, resume)``: resume from ``last_checkpoint`` in
  the output dir if present, else initialise from ``init_from``: a
  checkpoint of the port, an output dir holding one, or a released MADM
  ``.pth`` of the reference, which goes through ``convert_madm_pth`` and is
  overlaid on the model (``merge_into_model``; the optimizer and the step
  stay as they are; ``main.py:331-337``).  An orbax directory of the JAX
  package raises: reading it needs orbax, which the port does not use.
- ``PeriodicCheckpointer``: save ``model_{iter:07d}.pth`` every ``period``
  iterations and at the last, keep ``max_to_keep``.
- ``BestCheckpointer``: track a metric and keep ``model_best.pth``.

Under a process group, every rank calls ``save`` (the
ZeRO-1 optimizer state is consolidated on rank 0, in the layout of an
unsharded optimizer over the same groups) and rank 0 alone writes; every
rank loads.  So a checkpoint of a run at one world size resumes at another.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from ..parallel import dist as dist_lib
from ..train.train_step import add_feature_distance_baseline
from .converter import convert_madm_pth, merge_into_model

logger = logging.getLogger(__name__)

FORMAT = "madm_torch"


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    def save(self, name: str, state) -> None:
        """Write ``<name>.pth`` and point ``last_checkpoint`` at it (rank 0;
        every rank must call it)."""
        optimizer = dist_lib.consolidated_state_dict(state.optimizer)
        if dist_lib.is_main():
            path = self._path(f"{name}.pth")
            tmp = f"{path}.tmp"
            ckpt = {"format": FORMAT, "model": state.model.state_dict(), "optimizer": optimizer,
                    "step": int(state.step)}
            if state.consts:
                ckpt["consts"] = {k: m.state_dict() for k, m in state.consts.items()}
            torch.save(ckpt, tmp)
            os.replace(tmp, path)
            with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
                f.write(os.path.basename(path))
            logger.info(f"saved checkpoint {path}")
        dist_lib.barrier()

    def load(self, name: str, state):
        """Restore the checkpoint file ``name`` (under the save dir, or an
        absolute path) into ``state`` in place; returns ``state``."""
        return load_checkpoint(self._path(name), state)

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, "last_checkpoint"))

    def last_checkpoint(self) -> Optional[str]:
        p = os.path.join(self.save_dir, "last_checkpoint")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return f.read().strip()

    def resume_or_load(self, state, init_from: Optional[str] = None, resume: bool = True):
        """(state, resumed): reference ``resume_or_load`` semantics
        (``main.py:302,331``)."""
        if resume and self.has_checkpoint():
            name = self.last_checkpoint()
            logger.info(f"resuming from {name}")
            return self.load(name, state), True
        if init_from:
            logger.info(f"initializing from {init_from}")
            if os.path.isdir(init_from):
                src = Checkpointer(init_from)
                name = src.last_checkpoint()
                if name is not None and name.endswith(".pth"):
                    return src.load(name, state), False
                if name is not None or os.path.exists(os.path.join(init_from, "_METADATA")):
                    raise NotImplementedError(
                        f"{init_from} is an orbax checkpoint of the JAX package: reading it needs "
                        "orbax, which madm_torch does not use")
                raise FileNotFoundError(f"no checkpoint under {init_from}")
            return load_checkpoint(init_from, state), False
        return state, False


def load_checkpoint(path: str, state):
    """Restore a checkpoint file into ``state`` in place.  A file of the port
    restores the model (student, EMA teacher, BN statistics), the optimizer,
    the step and, for an ``fd`` run, the fd baseline; a released reference
    ``.pth`` overlays its weights on the model (JAX ``resume_or_load``,
    ``checkpointer.py:105-116``).  Files are unpickled with
    ``weights_only=True``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(ckpt, dict) and ckpt.get("format") == FORMAT):
        logger.info(f"{path} is not a madm_torch checkpoint: converting it as a released MADM .pth")
        merge_into_model(state.model, convert_madm_pth(ckpt))
        return state
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    if "consts" in ckpt and state.tc.fd:
        if not state.consts:
            add_feature_distance_baseline(state)
        for name, sd in ckpt["consts"].items():
            state.consts[name].load_state_dict(sd)
    return state


class PeriodicCheckpointer:
    def __init__(self, checkpointer: Checkpointer, period: int, max_iter: int,
                 max_to_keep: int = 1):
        self.ckpt = checkpointer
        self.period = period
        self.max_iter = max_iter
        self.max_to_keep = max_to_keep
        self._kept = []

    def step(self, iteration: int, state) -> None:
        it = iteration + 1
        if it % self.period != 0 and it != self.max_iter:
            return
        name = f"model_{iteration:07d}"
        self.ckpt.save(name, state)
        self._kept.append(name)
        while len(self._kept) > self.max_to_keep:
            old = self._kept.pop(0)
            if not dist_lib.is_main():
                continue
            try:
                os.remove(self.ckpt._path(f"{old}.pth"))
            except OSError:
                pass


class BestCheckpointer:
    def __init__(self, checkpointer: Checkpointer, metric: str = "mIoU", mode: str = "max"):
        self.ckpt = checkpointer
        self.metric = metric
        self.mode = mode
        self.best = None

    def step(self, metrics: Dict[str, float], state) -> bool:
        value = metrics.get(self.metric)
        if value is None:
            return False
        better = self.best is None or (value > self.best if self.mode == "max" else value < self.best)
        if better:
            self.best = value
            self.ckpt.save("model_best", state)
            logger.info(f"new best {self.metric}={value:.4f}")
        return better
