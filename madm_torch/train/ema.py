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
    """In place over the parameters of each (EMA, student) module pair, as
    two foreach ops over every tensor (under ``ema_w_unet`` the pairs hold
    the 860 M-parameter UNet); buffers (the teacher's BN statistics) are
    left to its own passes."""
    ema, student = [], []
    for e_mod, s_mod in pairs:
        sp = dict(s_mod.named_parameters())
        for name, e in e_mod.named_parameters():
            ema.append(e)
            student.append(sp[name].to(e.dtype))
    torch._foreach_mul_(ema, alpha)
    torch._foreach_add_(ema, student, alpha=1.0 - alpha)
