"""AdamW with MADM's parameter groups, its learning-rate schedule and the
global-norm clip (port of ``madm_tpu/train/optimizer.py``, the shipped
``adamw`` path).

- No weight decay on biases and norm scales (flax ``bias``/``scale``: here
  ``bias`` and the ``weight`` of GroupNorm, LayerNorm and BatchNorm); conv
  and linear weights and the learned prompts decay.
- The warmup + multi-step schedule evaluated at the update count.
- The clip is optax's ``clip_by_global_norm``: g * min(1, c / ||g||), with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ||g|| + 1e-6).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

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


def make_optimizer(model: nn.Module, named_params: Sequence[Tuple[str, nn.Parameter]],
                   lr: float = 5e-6, weight_decay: float = 0.05, betas=(0.9, 0.999),
                   eps: float = 1e-8) -> torch.optim.AdamW:
    """AdamW over ``named_params`` (names as in ``model.named_parameters()``),
    split into a decayed and an undecayed group."""
    norm_weights = {id(m.weight) for m in model.modules() if isinstance(m, _NORMS)}
    decay: List[nn.Parameter] = []
    no_decay: List[nn.Parameter] = []
    for name, p in named_params:
        (no_decay if name.endswith(".bias") or id(p) in norm_weights else decay).append(p)
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": weight_decay}, {"params": no_decay, "weight_decay": 0.0}],
        lr=lr, betas=betas, eps=eps)


@torch.no_grad()
def clip_by_global_norm_(params: Sequence[nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients by min(1, max_norm / ||g||) in place; returns the
    fp32 global norm ||g|| before the clip, as a device scalar."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    torch._foreach_mul_(grads, (max_norm / norm).clamp(max=1.0))
    return norm
