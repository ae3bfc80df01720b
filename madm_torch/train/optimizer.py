"""AdamW with MADM's parameter groups, its learning-rate schedules and the
global-norm clip (port of ``madm_tpu/train/optimizer.py``, the reference's
``adamw``).

- No weight decay on biases and norm scales (flax ``bias``/``scale``: here
  ``bias`` and the ``weight`` of GroupNorm, LayerNorm and BatchNorm); conv
  and linear weights and the learned prompts decay.
- The warmup + multi-step schedule (or, with ``--warmup_lr``, the warmup +
  linear decay) evaluated at the update count; ``set_lr`` writes it into
  each group times the group's ``lr_scale``.
- ``unet_lr``: the UNet's and the adapters' groups take ``lr_scale = unet_lr
  / lr``.  optax scales their whole AdamW update, decay included, by that
  ratio; torch's AdamW at lr * ratio computes the same update.
- The clip is optax's ``clip_by_global_norm``: g * min(1, c / ||g||), with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ||g|| + 1e-6).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.sd.layers import GroupNorm

_NORMS = (GroupNorm, nn.LayerNorm, nn.BatchNorm2d)


def lr_schedule(base_lr: float, max_iter: int, milestones=(0.88888, 0.96296),
                values=(1.0, 0.1, 0.01), warmup_factor: float = 0.067,
                warmup_length: float = 500 / 184375) -> Callable[[int], float]:
    """WarmupParamScheduler(MultiStepParamScheduler): steps at int(m * (2 *
    max_iter - 1)) updates rescaled to iterations, linear warmup from
    ``warmup_factor`` over ``warmup_length`` of training."""
    num_updates = 2 * max_iter - 1
    step_iters = [int(m * num_updates) / num_updates * max_iter for m in milestones]
    warmup_iters = warmup_length * max_iter

    def schedule(count: int) -> float:
        mult = values[0]
        for it, v in zip(step_iters, values[1:]):
            if count >= it:
                mult = v
        w = 1.0
        if count < warmup_iters:
            w = warmup_factor + (1 - warmup_factor) * (count / max(warmup_iters, 1e-8))
        return base_lr * mult * w

    return schedule


def linear_lr_schedule(base_lr: float, max_iter: int, warmup_length: float = 0.0375,
                       warmup_factor: float = 1e-6) -> Callable[[int], float]:
    """The ``--warmup_lr`` schedule: WarmupParamScheduler over
    LinearParamScheduler(start=1/(1-0.0375), end=0) (reference
    ``main.py:528-540``): s(f) = (1-f)/(1-w) reaches 1 where the warmup ends
    at f = w, then decays linearly to 0; f = count / max_iter in fp32, as the
    JAX schedule computes it."""
    def schedule(count: int) -> float:
        f = np.float32(count) / np.float32(max_iter)
        lin = max((np.float32(1.0) - f) / np.float32(1.0 - warmup_length), np.float32(0.0))
        w0 = np.float32(warmup_factor / (1.0 - warmup_length))
        warm = w0 + (np.float32(1.0) - w0) * (f / np.float32(warmup_length))
        return float(np.float32(base_lr) * (warm if f < warmup_length else lin))

    return schedule


def get_lr_schedule(base_lr: float, max_iter: int, schedule: str = "multistep") -> Callable[[int], float]:
    """'multistep' (the shipped configs) or 'linear' (``--warmup_lr``)."""
    if schedule == "linear":
        return linear_lr_schedule(base_lr, max_iter)
    if schedule != "multistep":
        raise ValueError(f"lr schedule {schedule!r} is not 'multistep' or 'linear'")
    return lr_schedule(base_lr, max_iter)


def make_optimizer(model: nn.Module, named_params: Sequence[Tuple[str, nn.Parameter]],
                   lr: float = 5e-6, weight_decay: float = 0.05, betas=(0.9, 0.999),
                   eps: float = 1e-8, unet_lr: Optional[float] = None) -> torch.optim.AdamW:
    """AdamW over ``named_params`` (names as in ``model.named_parameters()``),
    split into decayed and undecayed groups, each also split into the UNet
    and adapters (``lr_scale = unet_lr / lr``) and the rest (``lr_scale``
    1) when ``unet_lr`` is set."""
    norm_weights = {id(m.weight) for m in model.modules() if isinstance(m, _NORMS)}
    groups: Dict[Tuple[bool, bool], List[nn.Parameter]] = {}
    for name, p in named_params:
        decays = not (name.endswith(".bias") or id(p) in norm_weights)
        unet = unet_lr is not None and name.startswith(("unet.", "lora."))
        groups.setdefault((unet, decays), []).append(p)
    order = [(False, True), (False, False), (True, True), (True, False)]
    return torch.optim.AdamW(
        [{"params": groups[key], "weight_decay": weight_decay if key[1] else 0.0,
          "lr_scale": unet_lr / lr if key[0] else 1.0} for key in order if key in groups],
        lr=lr, betas=betas, eps=eps)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Each group's learning rate: ``lr`` times its ``lr_scale``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


@torch.no_grad()
def clip_by_global_norm_(params: Sequence[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / ||g||) in place; returns the
    fp32 global norm ||g|| before the clip, as a device scalar."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm
