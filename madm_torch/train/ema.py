"""EMA teacher (port of ``madm_tpu/train/ema.py``):
teacher <- alpha * teacher + (1 - alpha) * student,
alpha = min(1 - 1/(step + 1), ema_alpha), so step 0 copies the student."""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn


def ema_alpha(step: int, base_alpha: float = 0.999) -> float:
    return min(1.0 - 1.0 / (step + 1.0), base_alpha)


@torch.no_grad()
def update_ema(pairs: Iterable[Tuple[nn.Module, nn.Module]], alpha: float) -> None:
    """In place over the parameters of each (EMA, student) module pair;
    buffers (the teacher's BN statistics) are left to its own passes."""
    for ema, student in pairs:
        sp = dict(student.named_parameters())
        for name, e in ema.named_parameters():
            e.mul_(alpha).add_(sp[name].to(e.dtype), alpha=1.0 - alpha)
