"""Checkpoint save/resume (port of ``madm_tpu/checkpoint/checkpointer.py``;
reference ``checkpoint/odise_checkpointer.py``).

A checkpoint is one ``.pth`` file written by ``torch.save``: ``{"format":
"madm_torch", "model": state_dict, "optimizer": AdamW state_dict, "step":
int}``.  The model's ``state_dict`` has the reference key names and holds the
EMA teacher (``ema.*``) and the head's BN statistics (``running_mean`` /
``running_var`` of the student and the teacher); the frozen VAE is kept too
(the JAX package leaves it out because it re-materialises from the SD
snapshot, which the port cannot load yet, ROADMAP §A2).  Key behaviours as in
the JAX package:

- ``resume_or_load(init_from, resume)``: resume from ``last_checkpoint`` in
  the output dir if present, else initialise from ``init_from``, a
  checkpoint of the port or an output dir holding one (``main.py:331-337``).
  An orbax directory of the JAX package or a released reference ``.pth``
  raises: reading them waits for ROADMAP §A2.
- ``PeriodicCheckpointer``: save ``model_{iter:07d}.pth`` every ``period``
  iterations and at the last, keep ``max_to_keep``.
- ``BestCheckpointer``: track a metric and keep ``model_best.pth``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

FORMAT = "madm_torch"
_NOT_PORTED = ("reading it needs the checkpoint converter, which waits for ROADMAP §A2 "
               "(an SD-v1.4 snapshot and a MADM .pth in the repository)")


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.save_dir, name)

    def save(self, name: str, state) -> None:
        """Write ``<name>.pth`` and point ``last_checkpoint`` at it."""
        path = self._path(f"{name}.pth")
        tmp = f"{path}.tmp"
        torch.save({"format": FORMAT, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(), "step": int(state.step)}, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.save_dir, "last_checkpoint"), "w") as f:
            f.write(os.path.basename(path))
        logger.info(f"saved checkpoint {path}")

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
                        f"{init_from} is an orbax checkpoint of the JAX package: {_NOT_PORTED}")
                raise FileNotFoundError(f"no checkpoint under {init_from}")
            return load_checkpoint(init_from, state), False
        return state, False


def load_checkpoint(path: str, state):
    """Restore a checkpoint file of the port into ``state`` in place: the
    model (student, EMA teacher, BN statistics), the optimizer and the step.
    Anything else raises."""
    ckpt = torch.load(path, map_location=state.model.device, weights_only=True)
    if not (isinstance(ckpt, dict) and ckpt.get("format") == FORMAT):
        raise NotImplementedError(f"{path} is not a madm_torch checkpoint (a released reference "
                                  f".pth?): {_NOT_PORTED}")
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
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
